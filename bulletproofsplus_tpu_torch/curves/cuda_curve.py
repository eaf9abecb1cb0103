"""Point kernels K2–K5 (csrc/*.cu) with their plain PyTorch versions.

Port of bulletproofsplus_tpu/curves/pallas_curve.py. Each wrapper takes the
plain version for a CPU tensor and launches its kernel for a CUDA tensor
(or raises); `<wrapper>.launches` counts kernel launches, of both families.
The plain versions run on the curve's plain field ops, so they never launch
K1. Every kernel has two forms, as every TPU kernel has two bodies
(`_family`, pallas_curve.py:123-134): extended Edwards points (C = 4
coordinates, csrc/ed25519.cuh) and projective Weierstrass points (C = 3,
csrc/weierstrass.cuh), one template built once per point type and width;
the wrapper launches the entry point of `curve.FAMILY` (bpp_<kernel>_edwards,
bpp_<kernel>_weierstrass at 8 words, bpp_<kernel>_weierstrass12 at 12 for
bls12-381). Points are (..., C, L) with C = curve.COORDS and L = curve.fp.L;
scalars are plain-form (..., S) with S = curve.fn.L = 8 words on every curve,
so the kernels read coordinates and scalars at two widths.

- K2 `joint_ladder_msm_grouped` ← `_joint_ladder_call` (pallas_curve.py:606,
  pallas_call :718). One thread runs a whole group's ~900 dependent point
  ops (~1,000 at 256-bit scalars): within 1.5-2× of the integer-multiply
  bound at the prover's 10^5-10^6 groups, latency-bound at the verifier's
  few thousand; see csrc/joint_ladder.cu.
- K3 `sum_points_grouped` ← `_sum_points_call` (:475, pallas_call :553).
  A tree spread over the card in place of the TPU's sequential revisiting
  of one output window: `sum_layout` gives many groups a segment of 1-128
  threads each (strided runs, then shuffles), and a few groups many blocks
  each, whose partials the last block of the group reduces in the same
  launch; see csrc/sum_points.cu.
- K4 `fixed_lookup_partials` ← `_fixed_lookup_call` (:269, pallas_call
  :371). Bound by its adds, one a lane (its table reads, 128, 96 or 144 B
  a lane, weigh far less); the grid is the blocks the card holds at once,
  each thread a long run of lanes, one partial a block, which K3 reduces,
  because Hopper blocks cannot carry an accumulator across the grid the way
  the TPU's sequential grid does; see csrc/fixed_lookup.cu.
- K5 `ladder_scalar_mul` ← `_ladder_call` (:146, pallas_call :253). The
  four threads of a quad run one lane, each with its copy of the 16-entry
  table in shared memory; on the prover's 256 lanes it is bound by the
  latency of one lane's ~334 dependent point ops, which quad doublings and
  quad adds (one product a thread a round) cut to 2-4 product rounds each;
  see csrc/ladder.cu. It computes K2 at J = 1 in the same order, but keeps
  its own entry point and launch count.
- The bucket MSM `bucket_msm` ← no Pallas kernel: msm/pippenger.py:75-153
  is XLA (lax.scan, gather/scatter). Three kernels, each with its wrapper
  and plain version: `bucket_accumulate` (a thread per (row, slice,
  window) adds its run of points into its own 2^c buckets), `bucket_merge`
  (a thread per (row, window, digit) adds a bucket over the slices) and
  `bucket_reduce` (the quads of a warp form a window's Σ d·bucket_d over
  1-8 segments, or a thread a window where the card is full, then a quad
  a row runs Horner); see csrc/pippenger.cu.
  Rows may share their points (row r reads point row r mod prow), so K
  proofs over one key read one copy of its generators.

Tables are entry-major (nent, lanes, C, L) for both versions, where a lane
is a (window, point) pair, lane = window·N + point.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..fields.spec import int_to_words

WINDOW = 4
JWAYS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def _consts_words(curve):
    """CurveConsts of csrc/points.cuh at the base field's width L: p, -p⁻¹
    mod 2³², the formulas' constant (2d for Edwards, 3b for Weierstrass) and
    1 = 2^(32L) mod p, both Montgomery; built once a curve."""
    spec = curve.fp.spec
    L = spec.num_limbs
    words = (spec.p_words + [spec.n0inv]
             + int_to_words(curve.kconst_int * spec.r_mod_p % spec.modulus, L)
             + int_to_words(spec.r_mod_p, L))
    return (ctypes.c_uint32 * len(words))(*words)


def _cuda_ready(name, *pairs):
    from .. import kernels

    kernels.check_operands(name, *pairs)
    return kernels


# ---------------------------------------------------------------------------
# K2: joint ladder
# ---------------------------------------------------------------------------


def joint_ladder_plain(curve, scalars, points, nbits: int):
    """Plain K2. scalars (G, J, S) plain form, points (G, J, C, L) → (G, C, L):
    Σ_j s_j·P_j per group, by the kernel's exact operation order (tables
    k·P_j built by repeated adds, then MSB-first windows of 4 doublings and
    J table adds)."""
    c = curve.plain
    G, J = points.shape[:2]
    nwin = -(-nbits // WINDOW)
    tab = [c.identity_like((G, J), points.device), points]
    for _ in range(2, 1 << WINDOW):
        tab.append(c.add(tab[-1], points))
    table = torch.stack(tab, dim=2)                        # (G, J, 16, C, L)
    digits = c.fn.scalar_digits(scalars, nwin * WINDOW, WINDOW).long()
    rows = torch.arange(G, device=points.device)
    acc = c.identity_like((G,), points.device)
    for w in range(nwin - 1, -1, -1):
        for _ in range(WINDOW):
            acc = c.dbl(acc)
        for j in range(J):
            acc = c.add(acc, table[rows, j, digits[:, j, w]])
    return acc


def joint_ladder_msm_grouped(curve, scalars, points, nbits: int, jway: int):
    """K2 wrapper. scalars plain (..., N, S), points (..., N, C, L) with N a
    multiple of jway → (..., N/jway, C, L): consecutive groups of jway pairs
    each give Σ_j s_j·P_j."""
    if jway not in JWAYS:
        raise ValueError(f"jway must be one of {JWAYS}")
    lead = points.shape[:-3]
    N = points.shape[-3]
    if N % jway:
        raise ValueError("pair count must be a multiple of jway")
    C, L, S = curve.COORDS, curve.fp.L, curve.fn.L
    pts = points.reshape(-1, jway, C, L)
    scal = scalars.expand(*lead, N, S).reshape(-1, jway, S)
    G = pts.shape[0]
    if points.device.type == "cpu":
        out = joint_ladder_plain(curve, scal, pts, nbits)
    else:
        kernels = _cuda_ready("joint_ladder", (pts, torch.int32),
                              (scal, torch.int32))
        pts, scal = kernels.aligned(pts), kernels.aligned(scal)
        out = torch.empty((G, C, L), dtype=torch.int32, device=pts.device)
        if G:
            kernels.launch(f"bpp_joint_ladder_{curve.FAMILY}", pts.data_ptr(),
                           scal.data_ptr(), out.data_ptr(), G, jway, -(-nbits // WINDOW),
                           _consts_words(curve), device=pts.device)
            joint_ladder_msm_grouped.launches += 1
    return out.reshape(*lead, N // jway, C, L)


joint_ladder_msm_grouped.launches = 0


# ---------------------------------------------------------------------------
# K3: grouped point sum
# ---------------------------------------------------------------------------


def sum_points_plain(curve, points):
    """Plain K3. (G, W, C, L) → (G, C, L): pad W to a power of two with
    identities, then a halving tree of adds."""
    c = curve.plain
    G, W = points.shape[:2]
    n2 = 1 << max(0, (W - 1).bit_length())
    if n2 != W:
        pad = c.identity_like((G, n2 - W), points.device)
        points = torch.cat([points, pad], dim=1)
    while points.shape[1] > 1:
        half = points.shape[1] // 2
        points = c.add(points[:, :half], points[:, half:])
    return points[:, 0]


# threads of a K3 or K4 block (THREADS of csrc/sum_points.cu, fixed_lookup.cu)
BLOCK = 128


def sum_layout(G: int, W: int, resident: int) -> tuple:
    """(seg, nblk, quads_first) of a K3 launch over G groups of W points,
    where the card holds `resident` K3 blocks at once. A group takes a
    segment of seg threads, the power of two (at most BLOCK) that leaves
    each thread about two points. Fewer groups than a quarter of the
    resident blocks spread over nblk blocks each, as many as the card leaves
    a group and at most one for every 2·BLOCK points, so that one group
    alone still fills the card. quads_first (csrc/points.cuh,
    pt_segment_sum) takes the shorter chain where the launch leaves most of
    the card idle and the cheaper reduction where it fills it."""
    seg = min(BLOCK, 1 << max(0, (-(-W // 2) - 1).bit_length()))
    if seg == BLOCK and 4 * G < resident:
        return BLOCK, max(1, min(resident // G, -(-W // (2 * BLOCK)))), True
    return seg, 1, 4 * -(-G * seg // BLOCK) < resident


def sum_points_grouped(curve, points):
    """K3 wrapper: Σ over axis -3. points (..., W, C, L) → (..., C, L);
    leading axes are independent groups."""
    lead = points.shape[:-3]
    W = points.shape[-3]
    if W == 0:
        return curve.identity_like(lead, points.device).clone()
    C, L = curve.COORDS, curve.fp.L
    pts = points.reshape(-1, W, C, L)
    G = pts.shape[0]
    if points.device.type == "cpu":
        out = sum_points_plain(curve, pts)
    else:
        kernels = _cuda_ready("sum_points", (pts, torch.int32))
        pts = kernels.aligned(pts)
        seg, nblk, quads_first = sum_layout(G, W, kernels.resident_blocks(
            "bpp_sum_points", curve.FAMILY, pts.device)) if G else (1, 1, True)
        # the G sums, then (nblk > 1) scratch: G·nblk partial points and G tickets
        buf = torch.empty(G * C * L + (G * (nblk * C * L + 1) if nblk > 1 else 0),
                          dtype=torch.int32, device=pts.device)
        out = buf[:G * C * L].view(G, C, L)
        if G:
            kernels.launch(f"bpp_sum_points_{curve.FAMILY}", pts.data_ptr(), buf.data_ptr(),
                           buf[G * C * L:].data_ptr() if nblk > 1 else 0, G, W, seg, nblk,
                           int(quads_first), _consts_words(curve), device=pts.device)
            sum_points_grouped.launches += 1
    return out.reshape(*lead, C, L)


sum_points_grouped.launches = 0


# ---------------------------------------------------------------------------
# K4: fixed-base lookup-accumulate
# ---------------------------------------------------------------------------


def select_entries(curve, table, digits, signed: bool):
    """Each lane's table entry: (lanes, C, L). Signed digits are mag | neg<<8;
    entry mag-1 holds mag·Q, the sign negates, magnitude 0 is the identity."""
    lanes = torch.arange(table.shape[1], device=table.device)
    d = digits.long()
    if not signed:
        return table[d, lanes]
    c = curve.plain
    mag, neg = d & 0xFF, ((d >> 8) & 1).bool()
    sel = table[(mag.clamp(min=1) - 1), lanes]
    sel = c.select(neg, c.neg(sel), sel)
    return c.select(mag == 0, c.identity_like(sel.shape[:-2], sel.device), sel)


def fixed_lookup_plain(curve, table, digits, signed: bool):
    """Plain K4: the sum of every lane's selected entry, as one partial
    (1, C, L)."""
    return sum_points_plain(curve, select_entries(curve, table, digits, signed)[None])


def fixed_lookup_partials(curve, table, digits, signed: bool):
    """K4 wrapper. table (nent, lanes, C, L), digits (lanes,) int32 →
    (P, C, L) partial points whose sum is Σ_lanes table[digit, lane]."""
    nent, lanes = table.shape[:2]
    if nent != (8 if signed else 16) or digits.shape != (lanes,):
        raise ValueError("table/digit shapes do not match the table flavor")
    if table.device.type == "cpu":
        return fixed_lookup_plain(curve, table, digits, signed)
    kernels = _cuda_ready("fixed_lookup", (table, torch.int32),
                          (digits, torch.int32))
    table, digits = kernels.aligned(table), digits.contiguous()
    nblocks = max(1, min(kernels.resident_blocks("bpp_fixed_lookup", curve.FAMILY,
                                                 table.device), -(-lanes // BLOCK)))
    out = torch.empty((nblocks, curve.COORDS, curve.fp.L), dtype=torch.int32,
                      device=table.device)
    kernels.launch(f"bpp_fixed_lookup_{curve.FAMILY}", table.data_ptr(),
                   digits.data_ptr(), out.data_ptr(), lanes, int(signed), nblocks,
                   _consts_words(curve), device=table.device)
    fixed_lookup_partials.launches += 1
    return out


fixed_lookup_partials.launches = 0


def fixed_digits(curve, scalars, nbits: int, signed: bool):
    """Plain-form scalars (N, S) → lane digits (nwin·N,) int32 in the table's
    lane order (window-major), packed mag | neg<<8 when signed. Unsigned
    4-bit digits are the nibbles of the scalars' little-endian bytes, taken
    in four launches."""
    fn = curve.fn
    if signed:
        mag, neg = fn.scalar_digits_signed(scalars, nbits, WINDOW)
        digits = mag | (neg.to(mag.dtype) << 8)
        return digits.t().contiguous().reshape(-1)
    nwin = -(-nbits // WINDOW)
    b = scalars.contiguous().view(torch.uint8)[:, :-(-nwin // 2)].t().to(torch.int32)
    return torch.stack([b & 15, b >> 4], dim=1).reshape(-1, scalars.shape[0])[:nwin].reshape(-1)


# ---------------------------------------------------------------------------
# K5: per-lane whole ladder
# ---------------------------------------------------------------------------


def ladder_plain(curve, scalars, points, nbits: int):
    """Plain K5. scalars (N, S) plain form, points (N, C, L) → (N, C, L):
    s_i·P_i by the kernel's operation order, which is K2's at J = 1."""
    return joint_ladder_plain(curve, scalars[:, None], points[:, None], nbits)


def ladder_scalar_mul(curve, scalars, points, nbits: int):
    """K5 wrapper: s·P per lane. scalars plain (..., S), points (..., C, L);
    leading axes broadcast and are flattened into lanes."""
    if not 1 <= nbits <= 256:
        raise ValueError("nbits must be in [1, 256]")
    C, L, S = curve.COORDS, curve.fp.L, curve.fn.L
    lead = torch.broadcast_shapes(scalars.shape[:-1], points.shape[:-2])
    pts = points.expand(*lead, C, L).reshape(-1, C, L)
    scal = scalars.expand(*lead, S).reshape(-1, S)
    N = pts.shape[0]
    if points.device.type == "cpu":
        out = ladder_plain(curve, scal, pts, nbits)
    else:
        kernels = _cuda_ready("ladder", (pts, torch.int32), (scal, torch.int32))
        pts, scal = kernels.aligned(pts), kernels.aligned(scal)
        out = torch.empty((N, C, L), dtype=torch.int32, device=pts.device)
        if N:
            kernels.launch(f"bpp_ladder_{curve.FAMILY}", pts.data_ptr(),
                           scal.data_ptr(), out.data_ptr(), N, -(-nbits // WINDOW),
                           _consts_words(curve), device=pts.device)
            ladder_scalar_mul.launches += 1
    return out.reshape(*lead, C, L)


ladder_scalar_mul.launches = 0


# ---------------------------------------------------------------------------
# The bucket MSM: accumulate, merge, reduce (csrc/pippenger.cu)
# ---------------------------------------------------------------------------

# bucket memory one accumulate launch may take; more rows split into launches
BUCKET_BYTES = 2 * 1024**3
# threads of a block of the bucket kernels (THREADS of csrc/pippenger.cu)
BUCKET_THREADS = 128


def bucket_layout(R: int, N: int, nwin: int, c: int, point_bytes: int, resident: int,
                  prow: int = 1) -> tuple:
    """(slices, rows a launch) of a bucket MSM over R rows of N pairs. The
    slices are as many as leave the card's `resident` accumulate threads no
    more than full, at most √N (a thread's run, N/slices adds, against the
    merge's slices adds) and at most what BUCKET_BYTES holds; rows go in
    chunks (a multiple of prow) where even one slice of every row's buckets
    would not fit."""
    per_row = nwin * (1 << c) * point_bytes
    slices = max(1, min(resident // max(1, R * nwin), math.isqrt(max(1, N)),
                        BUCKET_BYTES // max(1, R * per_row)))
    rows = R if R * per_row * slices <= BUCKET_BYTES else max(
        prow, BUCKET_BYTES // per_row // prow * prow)
    return slices, rows


def bucket_accumulate_plain(curve, scalars, points, nwin: int, c: int, slices: int):
    """Plain accumulate: scalars (R, N, S) plain form, points (prow, N, C, L)
    with R a multiple of prow (row r reads point row r mod prow) → buckets
    (R, slices, nwin, 2^c, C, L). Slice s holds pairs [s·per, (s + 1)·per),
    per = ⌈N/slices⌉; step t adds pair s·per + t of every (row, slice) into
    bucket [row, s, w, digit w] for every window w, one gather, one point add
    over all (row, slice, window) lanes and one scatter (pippenger.py:86-106);
    a zero digit adds nothing, so bucket 0 stays the identity."""
    p = curve.plain
    R, N = scalars.shape[:2]
    prow = points.shape[0]
    dev = points.device
    per = -(-N // slices)
    digits = curve.fn.scalar_digits(scalars, nwin * c, c).long()          # (R, N, nwin)
    if slices * per != N:
        digits = torch.cat([digits, digits.new_zeros(R, slices * per - N, nwin)], dim=1)
        points = torch.cat([points, p.identity_like((prow, slices * per - N), dev)], dim=1)
    digits = digits.reshape(R, slices, per, nwin)
    points = points.reshape(prow, slices, per, *points.shape[-2:])
    ri = torch.arange(R, device=dev)[:, None, None]
    si = torch.arange(slices, device=dev)[None, :, None]
    wi = torch.arange(nwin, device=dev)[None, None, :]
    prows = torch.arange(R, device=dev) % prow
    buckets = p.identity_like((R, slices, nwin, 1 << c), dev).clone()
    for t in range(per):
        d = digits[:, :, t]                                               # (R, slices, nwin)
        cur = buckets[ri, si, wi, d]
        new = p.add(cur, points[prows, :, t][:, :, None])
        buckets[ri, si, wi, d] = p.select(d == 0, cur, new)
    return buckets


def bucket_accumulate(curve, scalars, points, nwin: int, c: int, slices: int):
    """Accumulate wrapper: bucket_accumulate_plain's contract."""
    R, N, S = scalars.shape
    prow = points.shape[0]
    C, L = curve.COORDS, curve.fp.L
    if R % prow or points.shape[1:] != (N, C, L) or not 1 <= c <= 16 or slices < 1:
        raise ValueError("bucket_accumulate: shapes, window or slices out of range")
    if points.device.type == "cpu":
        return bucket_accumulate_plain(curve, scalars, points, nwin, c, slices)
    kernels = _cuda_ready("pippenger_accumulate", (points, torch.int32), (scalars, torch.int32))
    pts, scal = kernels.aligned(points), kernels.aligned(scalars)
    out = torch.empty((R, slices, nwin, 1 << c, C, L), dtype=torch.int32, device=pts.device)
    if R:
        kernels.launch(f"bpp_pippenger_accumulate_{curve.FAMILY}", pts.data_ptr(),
                       scal.data_ptr(), out.data_ptr(), R, N, prow, nwin, c, slices,
                       _consts_words(curve), device=pts.device)
        bucket_accumulate.launches += 1
    return out


bucket_accumulate.launches = 0


def bucket_merge_plain(curve, buckets):
    """Plain merge: (R, slices, nwin, B, C, L) → (R, nwin, B, C, L), each
    bucket added over the slices in slice order."""
    p = curve.plain
    acc = buckets[:, 0]
    for s in range(1, buckets.shape[1]):
        acc = p.add(acc, buckets[:, s])
    return acc


def bucket_merge(curve, buckets):
    """Merge wrapper: bucket_merge_plain's contract."""
    R, slices, nwin, B = buckets.shape[:4]
    if buckets.device.type == "cpu":
        return bucket_merge_plain(curve, buckets)
    kernels = _cuda_ready("pippenger_merge", (buckets, torch.int32))
    bk = kernels.aligned(buckets)
    out = torch.empty((R, nwin, B, *bk.shape[-2:]), dtype=torch.int32, device=bk.device)
    if R:
        kernels.launch(f"bpp_pippenger_merge_{curve.FAMILY}", bk.data_ptr(), out.data_ptr(), R,
                       nwin, B.bit_length() - 1, slices, _consts_words(curve),
                       device=bk.device)
        bucket_merge.launches += 1
    return out


bucket_merge.launches = 0


REDUCE_SEGMENTS = 8     # most segments a window of the reduce (one warp of quads)


def reduce_segments(R: int, nwin: int, c: int, resident: int | None = None) -> int:
    """Segments a window of the reduce's window sums (csrc/pippenger.cu): the
    most, up to REDUCE_SEGMENTS and 2^c, whose quads (4 threads each) over
    R·nwin windows the card's `resident` threads of the window kernel hold
    at once; 0, a thread a window with no quads, where even one quad a
    window is more: the card is full, and a quad issues an add's products
    and shuffles on four lanes (on an H100 at 5,120 rows of 43 windows, c =
    6, 6.06 / 10.09 / 20.88 ms for the three families against one quad a
    window's 7.79 / 13.22 / 25.83; scripts/bench_torch_inv_reduce.py
    --segments). `resident` None (the plain versions) takes the most: the
    fewest sequential steps."""
    if resident is not None and 4 * R * nwin > resident:
        return 0
    nseg = min(REDUCE_SEGMENTS, 1 << c)
    while resident is not None and nseg > 1 and 4 * nseg * R * nwin > resident:
        nseg //= 2
    return nseg


def bucket_reduce_plain(curve, merged, c: int, segments: int = 1):
    """Plain reduce: (R, nwin, 2^c, C, L) → (R, C, L), the kernel's adds in
    its order. Per (row, window), `segments` segments s hold digits s +
    segments·j: running sums from the top give each S_s = Σ_j b and W_s =
    Σ_j j·b (digit 0 skipped); then T_s = Σ_(s' ≥ s) S_s' by a suffix scan,
    each W doubled log2(segments) times plus T_s where s ≥ 1, and a butterfly
    over the segments: Σ_d d·b_d. Then per row Horner MSB first from the top
    window's sum, c doublings and one add a window (pippenger.py:108-151).
    `segments` 0 (the kernel's thread a window) adds as 1 does."""
    p = curve.plain
    R, nwin, B = merged.shape[:3]
    if segments not in (0, 1, 2, 4, 8) or segments > B:
        raise ValueError("segments must be 0, 1, 2, 4 or 8, at most 2^c")
    ns = max(segments, 1)
    dev = merged.device
    seg = merged.reshape(R, nwin, B // ns, ns, *merged.shape[-2:])   # [.., j, s] = digit s + ns·j
    run = wsum = p.identity_like((R, nwin, ns), dev)
    for j in range(B // ns - 1, 0, -1):
        run = p.add(run, seg[:, :, j])
        wsum = p.add(wsum, run)
    if ns > 1:
        s = torch.arange(ns, device=dev)
        run = p.select(s != 0, p.add(run, seg[:, :, 0]), run)
        k = 1
        while k < ns:
            run = p.select(s + k < ns, p.add(run, run[:, :, (s + k) % ns]), run)
            k *= 2
        k = 1
        while k < ns:
            wsum = p.dbl(wsum)
            k *= 2
        wsum = p.select(s != 0, p.add(wsum, run), wsum)
        k = 1
        while k < ns:
            wsum = p.add(wsum, wsum[:, :, s ^ k])
            k *= 2
    tot = wsum[:, :, 0]
    acc = tot[:, nwin - 1]
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = p.dbl(acc)
        acc = p.add(acc, tot[:, w])
    return acc


def bucket_reduce(curve, merged, c: int, segments: int | None = None):
    """Reduce wrapper: bucket_reduce_plain's contract (the kernel refuses a
    segment count it does not take); `segments` None picks reduce_segments'
    count for the device (the card's resident threads of the window kernel;
    the most on the CPU)."""
    R, nwin, B = merged.shape[:3]
    if B != 1 << c:
        raise ValueError("bucket_reduce: bucket count is not 2^c")
    if merged.device.type == "cpu":
        return bucket_reduce_plain(curve, merged, c, reduce_segments(R, nwin, c)
                                   if segments is None else segments)
    kernels = _cuda_ready("pippenger_reduce", (merged, torch.int32))
    bk = kernels.aligned(merged)
    if segments is None:
        segments = reduce_segments(R, nwin, c, BUCKET_THREADS * kernels.resident_blocks(
            "bpp_pippenger_reduce", curve.FAMILY, bk.device))
    C, L = curve.COORDS, curve.fp.L
    # the R sums, then scratch: R·nwin window sums
    buf = torch.empty(R * C * L + R * nwin * C * L, dtype=torch.int32, device=bk.device)
    out = buf[:R * C * L].view(R, C, L)
    if R:
        kernels.launch(f"bpp_pippenger_reduce_{curve.FAMILY}", bk.data_ptr(), buf.data_ptr(),
                       buf[R * C * L:].data_ptr(), R, nwin, c, segments, _consts_words(curve),
                       device=bk.device)
        bucket_reduce.launches += 1
    return out


bucket_reduce.launches = 0


def bucket_msm(curve, scalars, points, nbits: int, c: int):
    """Σ_i s_ri·P_(r mod prow),i for scalars (R, N, S) plain form and points
    (prow, N, C, L), R a multiple of prow → (R, C, L): accumulate, merge
    (only with more than one slice) and reduce, over row chunks of at most
    BUCKET_BYTES of buckets (bucket_layout)."""
    R, N = scalars.shape[:2]
    prow = points.shape[0]
    nwin = -(-nbits // c)
    if not 1 <= c <= 16 or (nwin - 1) * c // 32 >= curve.fn.L:
        raise ValueError("window must be 1 to 16 bits and nbits within the scalar")
    if points.device.type == "cpu":
        resident = 1        # one slice: the plain versions' fastest (no merge)
    else:
        from .. import kernels

        resident = BUCKET_THREADS * kernels.resident_blocks(
            "bpp_pippenger_accumulate", curve.FAMILY, points.device)
    slices, rows = bucket_layout(R, N, nwin, c, curve.COORDS * curve.fp.L * 4, resident, prow)
    outs = []
    for r0 in range(0, R, rows):
        buckets = bucket_accumulate(curve, scalars[r0:r0 + rows], points, nwin, c, slices)
        merged = buckets[:, 0] if slices == 1 else bucket_merge(curve, buckets)
        outs.append(bucket_reduce(curve, merged, c))
        del buckets, merged
    return outs[0] if len(outs) == 1 else torch.cat(outs)
