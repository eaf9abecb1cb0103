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

The field kernels (csrc/field_ops.cu) move L-word elements: K1's product
and add/sub/neg read each distinct element of an operand once (a broadcast
operand's few) and write n; fe_sum reads its (B, R, C) input and writes
(B, C); these are bound by bytes, and only the product counts operations.
fe_pow is bound by operations: per element 14 table products, 4 squarings
a window below the top one, and one product a nonzero digit there (the
kernel skips a zero digit's product by 1).

The fs256 transcript's SHA-256 (csrc/sha256.cu, one thread a message)
reads each message once and writes a 32-byte digest, and does no
Montgomery product; at the K or 2K messages of a launch it is bound by
the latency of one thread's chain of compressions, which no count of bytes
or of the card's rate sees. Its floor: on the longest dependent path of a
round (e through Σ1 and the three-input add to the new e) lie 3 integer
operations, each starting no sooner than INT_DEP_CYCLES after the one
it waits for, 64 rounds a 64-byte block, at the card's boost clock. The
throughput term counts 14 operations a round and 10 a schedule step.

The fs256 chain kernel (csrc/fs256_chain.cu) runs K transcripts' chains
of absorbs and challenges in one launch; it reads the absorbed coordinate
words and the start states once and writes the challenges and the final
states. Its floor is one transcript's dependent path: every absorb's
blocks and, per challenge, the state step and one half (the two halves
are independent) at the chain term above, plus one Montgomery product (the
digest's reduction takes one product a half, both halves side by side,
and an add), whose dependent path is `fe_mul_depth` operations: each of
the product's nl rows runs four carry chains of nl operations, all
threading one carry flag, 4·nl² at INT_DEP_CYCLES each.

The bucket MSM (csrc/pippenger.cu) counts point adds and doublings at
the family's products each: accumulate one add a nonzero digit, at most
R·N·nwin (`launch_work` counts them all; where the scalars are at hand,
`bucket_adds` counts the run's own nonzero digits and `bound` takes that
count), reading the points and scalars once and writing every bucket;
merge (slices − 1) adds a bucket; reduce 2·(2^c − 1) adds a (row, window)
and Horner's c·nwin doublings and nwin adds a row, reading the buckets of
digits 1 and up once.

The work of a launch comes from the size arguments it passed to
`kernels.launch`, so chip_smoke.py and scripts/profile_torch_batch_verify.py
read the same formulas off the same launches (`recorded_launches`).
"""
from __future__ import annotations

import contextlib

HBM_BYTES_PER_S = 3.35e12
INT_MADS_PER_S = 16.75e12
SCALAR_BYTES = 32
CLOCK_HZ = 1.98e9          # H100 SXM boost clock
INT_DEP_CYCLES = 4         # cycles before a dependent integer ALU operation can start
SHA_ROUND_DEPTH = 3        # dependent operations a SHA-256 round, on its longest path
SHA_BLOCK_OPS = 64 * 14 + 48 * 10    # integer operations of one compression
CHAIN_STEP_WORDS = 9       # hashers_device.schedule_words: words of a chain step
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


def _distinct(n: int, inner: int, s_inner: int, s_outer: int) -> int:
    """Distinct elements a field kernel reads of an operand that it indexes
    as (i // inner)·s_outer + (i % inner)·s_inner, i < n."""
    return (1 if s_inner == 0 else inner) * (1 if s_outer == 0 else -(-n // inner))


def pow_muls(exp_words, nwin: int) -> int:
    """Montgomery products of one element's fe_pow chain."""
    if nwin == 0:
        return 0
    e = sum(int(w) << (32 * i) for i, w in enumerate(exp_words))
    nonzero = sum(1 for w in range(nwin - 1) if (e >> (4 * w)) & 15)
    return 14 + 4 * (nwin - 1) + nonzero


# field entry point → position of its word count in the launch's arguments
FIELD_WORDS = {"bpp_mont_mul": 10, "bpp_fe_add": 10, "bpp_fe_sub": 10, "bpp_fe_neg": 6,
               "bpp_fe_sum": 5, "bpp_fe_pow": 3}


def sha256_blocks(msg_bytes: int) -> int:
    """64-byte blocks of a padded message of msg_bytes bytes."""
    return (msg_bytes + 9 + 63) // 64


def sha256_ms(B: int, msg_bytes: int) -> tuple:
    """(bytes time, operations time) in ms of one bpp_sha256_words launch
    over B messages: the operations time is the larger of one thread's
    dependent chain and the card's integer rate over every compression."""
    nb = sha256_blocks(msg_bytes)
    t_bytes = B * (msg_bytes + 32) / HBM_BYTES_PER_S * 1e3
    chain = nb * 64 * SHA_ROUND_DEPTH * INT_DEP_CYCLES / CLOCK_HZ * 1e3
    rate = B * nb * SHA_BLOCK_OPS / INT_MADS_PER_S * 1e3
    return t_bytes, max(chain, rate)


def fe_mul_depth(nl: int) -> int:
    """Dependent operations of one CIOS Montgomery product of nl words."""
    return 4 * nl * nl


def chain_steps(words, nsteps: int) -> list:
    """(absorbs, rows absorbed, challenges) of each step of a chain
    schedule as the kernel takes it (hashers_device.schedule_words)."""
    w = list(words)
    return [(bool(w[CHAIN_STEP_WORDS * i]), w[CHAIN_STEP_WORDS * i + 3],
             w[CHAIN_STEP_WORDS * i + 4]) for i in range(nsteps)]


def chain_compressions(steps, row_words: int) -> tuple:
    """(compressions on one transcript's dependent path, compressions a
    transcript hashes in all) of a chain schedule, `steps` a list of
    (absorbs, rows absorbed, challenges)."""
    nchal = sum(c for _, _, c in steps)
    absorb = sum(sha256_blocks(4 * (9 + nr * row_words)) for a, nr, _ in steps if a)
    return absorb + 2 * nchal, absorb + 3 * nchal


def chain_bytes(steps, K: int, rows: int, row_words: int) -> int:
    """Bytes one bpp_fs256_chain launch moves: the coordinate words and the
    start states read once, the challenges and the final states written."""
    nchal = sum(c for _, _, c in steps)
    return K * (rows * row_words * 4 + 32 + nchal * 32 + 32)


def fs256_chain_ms(steps, K: int, rows: int, row_words: int) -> tuple:
    """(bytes time, operations time) in ms of one bpp_fs256_chain launch over
    K transcripts of `rows` coordinate rows of `row_words` words: the
    operations time is the larger of one transcript's dependent path and
    the card's integer rate over every compression of the launch."""
    nchal = sum(c for _, _, c in steps)
    path, total = chain_compressions(steps, row_words)
    t_bytes = chain_bytes(steps, K, rows, row_words) / HBM_BYTES_PER_S * 1e3
    chain = ((path * 64 * SHA_ROUND_DEPTH + nchal * fe_mul_depth(8)) * INT_DEP_CYCLES
             / CLOCK_HZ * 1e3)
    rate = K * (total * SHA_BLOCK_OPS + nchal * 2 * fe_mul_mads(8)) / INT_MADS_PER_S * 1e3
    return t_bytes, max(chain, rate)


def bucket_adds(digits) -> int:
    """Accumulate's point adds for c-bit digits (any shape): one a nonzero
    digit."""
    return int((digits != 0).sum())


def launch_work(name: str, args, adds: int | None = None) -> tuple:
    """(bytes, Montgomery products) of one launch of C entry point `name`
    with the arguments `args` it was given (pointers first, as in
    kernels.SIGNATURES). `adds`, for a bucket accumulate launch, is the
    count of its nonzero digits (bucket_adds) in place of every lane's
    window."""
    if name == "bpp_sha256_words":
        B, msg_bytes = args[2:4]
        return B * (msg_bytes + 32), 0
    if name == "bpp_fs256_chain":
        # the digest's reduction: two products a challenge
        K, rows, row_words, sched, nsteps = args[5:10]
        steps = chain_steps(sched, nsteps)
        return chain_bytes(steps, K, rows, row_words), 2 * K * sum(c for _, _, c in steps)
    if name in ("bpp_mont_mul", "bpp_fe_add", "bpp_fe_sub"):
        n, nl = args[9:11]
        read = _distinct(n, *args[1:4]) + _distinct(n, *args[5:8])
        return (read + n) * 4 * nl, (n if name == "bpp_mont_mul" else 0)
    if name == "bpp_fe_neg":
        n, nl = args[5:7]
        return (_distinct(n, *args[1:4]) + n) * 4 * nl, 0
    if name == "bpp_fe_sum":
        B, R, C, nl = args[2:6]
        return B * (R + 1) * C * 4 * nl, 0
    if name == "bpp_fe_pow":
        n, nl, exp_words, nwin = args[2:6]
        return 2 * n * 4 * nl, n * pow_muls(exp_words, nwin)
    name, family = name.rsplit("_", 1)
    if family not in FAMILIES:
        raise ValueError(f"no work model for {name}_{family}")
    add, dbl, _, pt = FAMILIES[family]
    if name == "bpp_pippenger_accumulate":
        R, N, prow, nwin, c, slices = args[3:9]
        return (prow * N * pt + R * N * SCALAR_BYTES + R * slices * nwin * (pt << c),
                (R * N * nwin if adds is None else adds) * add)
    if name == "bpp_pippenger_merge":
        R, nwin, c, slices = args[2:6]
        return R * nwin * (pt << c) * (slices + 1), R * nwin * (1 << c) * (slices - 1) * add
    if name == "bpp_pippenger_reduce":
        R, nwin, c = args[3:6]
        B = 1 << c
        return (R * nwin * (B - 1) * pt + R * pt,
                R * nwin * 2 * (B - 1) * add + R * nwin * (c * dbl + add))
    if name == "bpp_joint_ladder":
        G, J, nwin = args[3:6]
        return (G * J * (pt + SCALAR_BYTES) + G * pt,
                ladder_muls(G, J, nwin, family))
    if name == "bpp_sum_points":
        # the work of the sum whatever its layout: the partials that a group
        # spread over several blocks passes through scratch are not counted
        G, W = args[3:5]
        return G * W * pt + G * pt, G * (W - 1) * add
    if name == "bpp_fixed_lookup":
        lanes, nblocks = args[3], args[5]
        return lanes * (pt + 4) + nblocks * pt, lanes * add
    if name == "bpp_ladder":
        N, nwin = args[3:5]
        return N * (2 * pt + SCALAR_BYTES), ladder_muls(N, 1, nwin, family)
    raise ValueError(f"no work model for {name}_{family}")


def launch_words(name: str, args) -> int:
    """Words of the field elements one launch multiplies."""
    if name in FIELD_WORDS:
        return args[FIELD_WORDS[name]]
    return FAMILIES[name.rsplit("_", 1)[1]][2]


def bound(calls, adds: int | None = None) -> tuple:
    """(bound_ms, bound_by) of a sequence of (name, args) launches: the sum
    of each launch's bound, and whether bytes or operations weigh more.
    `adds` counts the nonzero digits of the one bucket accumulate launch
    among them (launch_work)."""
    total = t_bytes = t_ops = 0.0
    for name, args in calls:
        if name == "bpp_sha256_words":
            tb, to = sha256_ms(*args[2:4])
        elif name == "bpp_fs256_chain":
            K, rows, row_words, sched, nsteps = args[5:10]
            tb, to = fs256_chain_ms(chain_steps(sched, nsteps), K, rows, row_words)
        else:
            nbytes, muls = launch_work(name, args, adds)
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
