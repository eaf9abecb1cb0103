// The point family of one build of a point kernel's source.
//
// kernels.py compiles each point-kernel source (joint_ladder.cu,
// sum_points.cu, fixed_lookup.cu, ladder.cu) once per family, with
// -DBPP_FAMILY=0 (Edwards) or -DBPP_FAMILY=1 (Weierstrass), so the two
// families build in parallel. FamilyPt is that family's point type and
// BPP_ENTRY(bpp_x) the build's C entry point, bpp_x_edwards or
// bpp_x_weierstrass.
#pragma once

#if BPP_FAMILY == 0
#include "ed25519.cuh"
using FamilyPt = bpp::Pt4;
#define BPP_ENTRY(name) name##_edwards
#elif BPP_FAMILY == 1
#include "weierstrass.cuh"
using FamilyPt = bpp::Pt3;
#define BPP_ENTRY(name) name##_weierstrass
#else
#error "build with -DBPP_FAMILY=0 (Edwards) or -DBPP_FAMILY=1 (Weierstrass)"
#endif
