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
fe_pow's operations are per element 14 table products, 4 squarings a
window below the top one, and one product a nonzero digit there (the
kernel skips a zero digit's product by 1); those products form one
dependent chain, so its operations time is the larger of the card's rate
over all of them and one element's chain of products at `fe_mul_depth`
dependent operations each, INT_DEP_CYCLES apart (`fe_pow_ms`). A product's
`fe_mul_depth` is the part of its dependent path that no schedule of
32-bit words avoids: the reduction's nl quotient words form a chain, each
m_(i+1) = t_0·(−p⁻¹) mod 2^32 waiting on a product of m_i (which feeds
t_0) and then on its own product, 2·nl operations; the carry chains
beside it (4·nl² operations if each ran after the last) a kernel can
overlap, so they are not counted. fe_inv's work is the modulus's divsteps
(FieldSpec.divsteps, Bernstein and Yang's bound for its bit length, which
the launch's constants carry), each a dependent path of DIVSTEP_DEPTH
operations (test g's low bit, add or subtract f, halve), which no
batching of the steps shortens; its operations time is the larger of
that chain for one element and the card's rate over every element's
divsteps (`fe_inv_ms`). Both read and write n elements.

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
and an add) at `fe_mul_depth` dependent operations, INT_DEP_CYCLES apart.

The bucket MSM (csrc/pippenger.cu) counts point adds and doublings at
the family's products each: accumulate one add a nonzero digit, at most
R·N·nwin (`launch_work` counts them all; where the scalars are at hand,
`bucket_adds` counts the run's own nonzero digits and `bound` takes that
count), reading the points and scalars once and writing every bucket;
merge (slices − 1) adds a bucket; reduce 2·(2^c − 1) adds a (row, window)
and Horner's c·(nwin − 1) doublings and nwin − 1 adds a row, reading the
buckets of digits 1 and up once. The reduce's operations time is the
larger of the card's rate over those adds and one row's dependent chain
(`reduce_ms`): Horner's c·(nwin − 1) doublings and nwin − 1 adds, after a
window sum of log depth (c adds: a tree over its 2^c − 1 weighted
buckets), each point op at its family's dependent product levels (LEVELS:
the products of an add or a doubling that must follow one another) ×
`fe_mul_depth`, INT_DEP_CYCLES apart.

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
# family → dependent product levels of (an add, a doubling): hwcd's add
# (its four products, 2d·T1·T2, then the four outputs) and doubling (four
# squares, then the outputs); RCB's add and doubling one level deeper
LEVELS = {"edwards": (3, 2), "weierstrass": (4, 3), "weierstrass12": (4, 3)}
DIVSTEP_DEPTH = 3          # dependent operations of a divstep: test, add, halve


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
               "bpp_fe_sum": 5, "bpp_fe_pow": 3, "bpp_fe_inv": 3}


def dep_ms(ops: int) -> float:
    """ms of a chain of `ops` dependent integer operations, INT_DEP_CYCLES
    apart at the boost clock."""
    return ops * INT_DEP_CYCLES / CLOCK_HZ * 1e3


def fe_pow_ms(n: int, nl: int, exp_words, nwin: int) -> tuple:
    """(bytes time, operations time) in ms of one bpp_fe_pow launch over n
    elements: the larger of one element's chain of products and the card's
    rate over all of them."""
    muls = pow_muls(exp_words, nwin)
    rate = n * muls * fe_mul_mads(nl) / INT_MADS_PER_S * 1e3
    return 2 * n * 4 * nl / HBM_BYTES_PER_S * 1e3, max(rate, dep_ms(muls * fe_mul_depth(nl)))


def fe_inv_ms(n: int, nl: int, consts) -> tuple:
    """(bytes time, operations time) in ms of one bpp_fe_inv launch over n
    elements: the larger of one element's chain of divsteps and the card's
    rate over every element's."""
    steps = int(consts[0])      # FieldSpec.inv_consts: FieldSpec.divsteps first
    rate = n * steps * DIVSTEP_DEPTH / INT_MADS_PER_S * 1e3
    return 2 * n * 4 * nl / HBM_BYTES_PER_S * 1e3, max(rate, dep_ms(steps * DIVSTEP_DEPTH))


def reduce_chain_ops(family: str, nwin: int, c: int) -> int:
    """Dependent operations of one row of the bucket reduce: the window
    sum's c add levels, then Horner's c·(nwin − 1) doublings and nwin − 1
    adds, each at the family's dependent product levels of fe_mul_depth."""
    add_lv, dbl_lv = LEVELS[family]
    levels = c * add_lv + (nwin - 1) * (c * dbl_lv + add_lv)
    return levels * fe_mul_depth(FAMILIES[family][2])


def reduce_ms(family: str, R: int, nwin: int, c: int) -> tuple:
    """(bytes time, operations time) in ms of one bpp_pippenger_reduce
    launch: the larger of the card's rate over its adds and doublings and
    one row's chain."""
    nbytes, muls = launch_work(f"bpp_pippenger_reduce_{family}", (0, 0, 0, R, nwin, c))
    rate = muls * fe_mul_mads(FAMILIES[family][2]) / INT_MADS_PER_S * 1e3
    return nbytes / HBM_BYTES_PER_S * 1e3, max(rate, dep_ms(reduce_chain_ops(family, nwin, c)))


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
    """Dependent operations of one Montgomery product of nl 32-bit words
    that no kernel avoids: its chain of nl quotient words, two a word."""
    return 2 * nl


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
    if name == "bpp_fe_inv":
        # no Montgomery product: fe_inv_ms counts its divsteps
        n, nl = args[2:4]
        return 2 * n * 4 * nl, 0
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
                R * nwin * 2 * (B - 1) * add + R * (nwin - 1) * (c * dbl + add))
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
        elif name == "bpp_fe_pow":
            tb, to = fe_pow_ms(*args[2:6])
        elif name == "bpp_fe_inv":
            tb, to = fe_inv_ms(*args[2:5])
        elif name.startswith("bpp_pippenger_reduce_"):
            tb, to = reduce_ms(name.rsplit("_", 1)[1], *args[3:6])
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
