"""The least time an H100 SXM could take for the work of a kernel launch.

A launch's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over HBM's 3.35 TB/s, and its
integer multiply-adds over the card's int32 multiply rate. NVIDIA's data
sheet gives 67 TFLOP/s in float32, i.e. 33.5 T FMA/s on 128 lanes an SM;
the int32 multiply pipe has 64, so 16.75 T multiply-adds/s. A 32×32→64
product counts as two (low and high word); a CIOS Montgomery product of NL
words has 2·NL² of them and NL low products: 4·NL² + NL multiply-adds (264
at NL = 8, 588 at NL = 12). Adds, subtracts and selects are free. Per point
family (the suffix of a point kernel's entry point):

- Edwards: an add has 9 Montgomery products, a doubling 8 (hwcd); a
  point is 4 coordinates of 8 words, 128 bytes.
- Weierstrass: an add has 14, a doubling 9 (RCB algorithms 7 and 9,
  `_wadd`/`_wdbl` of bulletproofsplus_tpu/curves/pallas_curve.py); a point
  is 3 coordinates of 8 words, 96 bytes, or of 12 words (weierstrass12,
  bls12-381), 144 bytes. Scalars are 8 words, 32 bytes, on every curve.

The work of a launch comes from the size arguments it passed to
`kernels.launch`, so chip_smoke.py and scripts/profile_torch_batch_verify.py
read the same formulas off the same launches (`recorded_launches`).
"""
from __future__ import annotations

import contextlib

HBM_BYTES_PER_S = 3.35e12
INT_MADS_PER_S = 16.75e12
SCALAR_BYTES = 32
# family → (products of an add, of a doubling, words of a coordinate,
# bytes of a point)
FAMILIES = {"edwards": (9, 8, 8, 128), "weierstrass": (14, 9, 8, 96),
            "weierstrass12": (14, 9, 12, 144)}


def fe_mul_mads(nl: int) -> int:
    """Integer multiply-adds of one CIOS Montgomery product of nl words."""
    return nl * (4 * nl + 1)


def ladder_muls(groups: int, jway: int, nwin: int, family: str = "edwards") -> int:
    """Montgomery products of `groups` J-way windowed ladders (tables by 14
    adds each, then nwin windows of 4 doublings and J adds)."""
    add, dbl = FAMILIES[family][:2]
    return groups * (jway * 14 * add + nwin * (4 * dbl + jway * add))


def launch_work(name: str, args) -> tuple:
    """(bytes, Montgomery products) of one launch of C entry point `name`
    with the arguments `args` it was given (pointers first, as in
    kernels.SIGNATURES)."""
    if name == "bpp_mont_mul":
        n, nl = args[3:5]
        return n * 3 * 4 * nl, n
    name, family = name.rsplit("_", 1)
    add, _, _, pt = FAMILIES[family]
    if name == "bpp_joint_ladder":
        G, J, nwin = args[3:6]
        return (G * J * (pt + SCALAR_BYTES) + G * pt,
                ladder_muls(G, J, nwin, family))
    if name == "bpp_sum_points":
        G, W = args[2:4]
        return G * W * pt + G * pt, G * (W - 1) * add
    if name == "bpp_fixed_lookup":
        lanes, nblocks = args[3], args[5]
        return lanes * (pt + 4) + nblocks * pt, lanes * add
    if name == "bpp_ladder":
        N, nwin = args[3:5]
        return N * (2 * pt + SCALAR_BYTES), ladder_muls(N, 1, nwin, family)
    raise ValueError(f"no work model for {name}")


def launch_words(name: str, args) -> int:
    """Words of the field elements one launch multiplies."""
    if name == "bpp_mont_mul":
        return args[4]
    return FAMILIES[name.rsplit("_", 1)[1]][2]


def bound(calls) -> tuple:
    """(bound_ms, bound_by) of a sequence of (name, args) launches: the sum
    of each launch's bound, and whether bytes or operations weigh more."""
    total = t_bytes = t_ops = 0.0
    for name, args in calls:
        nbytes, muls = launch_work(name, args)
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = muls * fe_mul_mads(launch_words(name, args)) / INT_MADS_PER_S * 1e3
        total += max(tb, to)
        t_bytes += tb
        t_ops += to
    return total, ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def recorded_launches():
    """Within the block, every kernels.launch call is also appended, as
    (name, args), to the list this yields."""
    from . import kernels

    calls = []
    launch = kernels.launch

    def recording(name, *args, device):
        calls.append((name, args))
        launch(name, *args, device=device)

    kernels.launch = recording
    try:
        yield calls
    finally:
        kernels.launch = launch
