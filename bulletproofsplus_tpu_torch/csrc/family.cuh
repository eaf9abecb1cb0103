// The point family of one build of a point kernel's source.
//
// kernels.py compiles each point-kernel source (joint_ladder.cu,
// sum_points.cu, fixed_lookup.cu, ladder.cu, pippenger.cu) once per family, with
// -DBPP_FAMILY=0 (Edwards, 8 words), 1 (Weierstrass, 8 words) or 2
// (Weierstrass, 12 words), so the families build in parallel. FamilyPt is
// that family's point type and BPP_ENTRY(bpp_x) the build's C entry point,
// bpp_x_edwards, bpp_x_weierstrass or bpp_x_weierstrass12: named by point
// type and width, not by curve.
#pragma once

#if BPP_FAMILY == 0
#include "ed25519.cuh"
using FamilyPt = bpp::Pt4;
#define BPP_ENTRY(name) name##_edwards
#elif BPP_FAMILY == 1
#include "weierstrass.cuh"
using FamilyPt = bpp::Pt3<8>;
#define BPP_ENTRY(name) name##_weierstrass
#elif BPP_FAMILY == 2
#include "weierstrass.cuh"
using FamilyPt = bpp::Pt3<12>;
#define BPP_ENTRY(name) name##_weierstrass12
#else
#error "build with -DBPP_FAMILY=0 (Edwards), 1 (Weierstrass) or 2 (Weierstrass, 12 words)"
#endif
