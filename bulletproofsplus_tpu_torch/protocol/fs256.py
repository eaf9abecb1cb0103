"""The fs256 transcript on the card: the verifier's replay and the prover's
in-fold challenges.

Port of bulletproofsplus_tpu/protocol/fs256.py: `_affine_words` (:37-51),
`_absorb_points` (:54-61), `_challenge_mont` (:64-84), `fs256_replay`
(:137-193) and the K-batched sound fold `_wip_prove_fs256_kbatched_prog`
(:201-320, here `wip_prove_fs256_batched`). Every chain runs in the fs256
chain kernel (csrc/fs256_chain.cu, via hashers_device.fs256_chain), K
transcripts a launch: the verifier's whole replay is one affine conversion
and one launch; the prover launches it once for the statement's y and z,
once a round and once for the final challenge. The vmapped and
single-proof JAX programs (:87-134, :328-336) are XLA machinery; the
batched form at K = 1 covers them.

The byte protocol is transcript.py::Fs256Transcript's, word for word:
coordinates are affine, plain, big-endian words; the identity absorbs as
the family's image under Z⁻¹ = 0 (Fermat's 0^(p−2) = 0): (0, 1) on Edwards
curves, (0, 0) on Weierstrass curves. A challenge of value 0 maps to 1, as
on the host twin. Every chain starts from the state it is given: the
transcripts' own (`state_words()`, which carries their label). The JAX
package's in-graph replay (:154-160) always starts from FS256_LABEL's
state; the port deliberately follows the host twin instead, so a custom
label verifies on the card as on the host.
"""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from ..hashers_device import Step, field_be_words, fs256_chain, words_tensor
from ..transcript import FS256_LABEL
from .wip import fold


def initial_state(m: int, lead, device) -> torch.Tensor:
    """SHA256(FS256_LABEL ‖ be32(m)), the start state of Fs256Transcript(m)
    under the default label, as (*lead, 8) words."""
    state0 = hashlib.sha256(FS256_LABEL + m.to_bytes(4, "big")).digest()
    words = np.frombuffer(state0, ">u4").astype(np.uint32)
    return words_tensor(words, device).expand(*lead, 8)


def affine_words(curve, pts: torch.Tensor) -> torch.Tensor:
    """Points (..., k, C, L), Montgomery form → their affine coordinates as
    big-endian words (..., k·2·L), in the order x_1, y_1, x_2, y_2, ....
    One Fermat inversion of every Z (one launch; 0 → 0 for the Weierstrass
    identity), one product back to plain form and one for both coordinates."""
    fp = curve.fp
    zi = fp.from_mont(fp.inv(pts[..., 2, :]))                  # plain Z⁻¹
    xy = fp.mul(pts[..., :2, :], zi[..., None, :])             # plain x, y
    return field_be_words(fp, xy).reshape(*pts.shape[:-3], -1)


def statement_step(m: int, row0: int = 0) -> Step:
    """Absorb the m commitments and A, then draw y and z."""
    return Step(b"stmt", (row0, m + 1), ((b"y   ", 1), (b"z   ", 2)))


def round_step(r: int, row0: int = 0) -> Step:
    """Absorb round r's L and R, then draw its e."""
    return Step(b"LR  ", (row0, 2), ((b"e   ", r + 3),))


def final_step(logn: int, row0: int = 0) -> Step:
    """Absorb the final A and B, then draw the final e."""
    return Step(b"AB  ", (row0, 2), ((b"ef  ", logn + 3),))


@functools.lru_cache(maxsize=None)
def replay_schedule(m: int, logn: int) -> tuple:
    """The verifier's chain over the rows V_1..V_m, A, (L_r, R_r) a round,
    A_wip, B: y, z, e_0..e_{logn−1}, e_final."""
    rounds = tuple(round_step(r, m + 1 + 2 * r) for r in range(logn))
    return (statement_step(m), *rounds, final_step(logn, m + 1 + 2 * logn))


def absorb_and_draw(curve, state, base, step: Step, pts):
    """One chain step over K transcripts: absorb the points (K, k, C, L),
    rows [0, k) of `step`, then draw its challenges. state (K, 8); base
    (K,) int32 counters before the chain, or None for 0. Returns
    (challenges (K, S, 8) Montgomery, the new state (K, 8))."""
    cw = affine_words(curve, pts).reshape(*pts.shape[:2], -1)
    return fs256_chain(curve.fn, state, base, cw, (step,))


def fs256_replay(curve, m: int, V, A, L_vec, R_vec, Aw, B, state=None):
    """The verifier's challenges of K proofs, derived on the card exactly as
    the host twin derives them from unused transcripts, with no host decode
    or hash. V (K, m, C, L); A, Aw, B (K, C, L); L_vec, R_vec (K, logn, C,
    L); state (K, 8) the transcripts' start states (their `state_words()`),
    by default that of `Fs256Transcript(m)` under FS256_LABEL. Returns
    Montgomery (y (K, 8), z (K, 8), es (K, logn, 8), e_final (K, 8)). Every
    absorbed point goes to affine in one conversion, each round's L and R
    side by side, then one chain launch runs every absorb and challenge."""
    K, logn = A.shape[0], L_vec.shape[1]
    LR = torch.stack([L_vec, R_vec], dim=2).reshape(K, 2 * logn, *A.shape[1:])
    pts = torch.cat([V, A[:, None], LR, Aw[:, None], B[:, None]], dim=1)
    cw = affine_words(curve, pts).reshape(K, pts.shape[1], -1)
    if state is None:
        state = initial_state(m, (K,), A.device)
    ch, _ = fs256_chain(curve.fn, state, None, cw, replay_schedule(m, logn))
    return ch[:, 0], ch[:, 1], ch[:, 2:2 + logn], ch[:, 2 + logn]


def wip_prove_fs256_batched(curve, a, b, power_of_y, alpha, G, H, g, h, state,
                            dLs_m, dRs_m, r_m, s_m, delta_m, eta_m, base=None):
    """The sound fold of K proofs with its challenges drawn on the card
    (fs256.py:201-320): protocol/wip.py's fold, each round's e derived from
    (L, R) and the final one from (A, B) by the transcript chain on the
    (K, 8) states. `state` is the chain after the statement's y and z;
    `base` (K,) int32 the transcripts' counters before y, or None for 0. ŷ is
    inverted once up front, each round's e by one Fermat inversion. Each
    round's challenge and the final one are one chain launch each. Returns
    the fold's proof tensors (as wip_prove_known_batched) and the chain's
    final state."""
    fn = curve.fn
    n = a.shape[1]
    logn = n.bit_length() - 1
    hs = [n >> (r + 1) for r in range(logn)]
    _, ynhat_invs = fn.batch_invert(power_of_y[:, [h_ - 1 for h_ in hs]], axis=1)

    def round_challenge(r, LR):
        nonlocal state
        with record_function("bpp::fs256_challenge"):
            ch, state = absorb_and_draw(curve, state, base, round_step(r), LR)
            e_m = ch[:, 0]
            e_inv = fn.inv(e_m)
            return e_m, e_inv, fn.mul(e_m, e_m), fn.mul(e_inv, e_inv)

    def final_challenge(AB):
        nonlocal state
        with record_function("bpp::fs256_challenge"):
            ch, state = absorb_and_draw(curve, state, base, final_step(logn), AB)
            return ch[:, 0]

    out = fold(curve, a, b, power_of_y, alpha, G, H, g, h, dLs_m, dRs_m,
               r_m, s_m, delta_m, eta_m, ynhat_invs, round_challenge, final_challenge)
    return (*out, state)
