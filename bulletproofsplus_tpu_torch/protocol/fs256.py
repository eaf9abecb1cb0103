"""The fs256 transcript on the card: the verifier's replay and the prover's
in-fold challenges.

Port of bulletproofsplus_tpu/protocol/fs256.py: `_affine_words` (:37-51),
`_absorb_points` (:54-61), `_challenge_mont` (:64-84), `fs256_replay`
(:137-193) and the K-batched sound fold `_wip_prove_fs256_kbatched_prog`
(:201-320, here `wip_prove_fs256_batched`). Every function carries the
leading K axis, so each SHA-256 call is one launch of the kernel
(csrc/sha256.cu, via hashers_device.sha256_words) for the whole batch and
each field step one launch of K1 or the field kernels. The vmapped and
single-proof JAX programs (:87-134, :328-336) are XLA machinery; the
batched form at K = 1 covers them.

The byte protocol is transcript.py::Fs256Transcript's, word for word:
coordinates are affine, plain, big-endian words; the identity absorbs as
the family's image under Z⁻¹ = 0 (Fermat's 0^(p−2) = 0): (0, 1) on Edwards
curves, (0, 0) on Weierstrass curves. A challenge of value 0 maps to 1, as
on the host twin.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from ..hashers_device import (
    digest_to_field_mont,
    field_be_words,
    sha256_words,
    tag_words,
    words_tensor,
)
from ..transcript import FS256_LABEL
from .wip import fold

_CONSTS: dict = {}


def _const(key, make, device) -> torch.Tensor:
    """A small constant tensor on `device`, built once (no host copy a call)."""
    full = (key, str(device))
    if full not in _CONSTS:
        _CONSTS[full] = make().to(device)
    return _CONSTS[full]


def _words(vals, lead, device) -> torch.Tensor:
    """Constant uint32 words (a tuple of ints or tag bytes) broadcast to
    (*lead, n) int32."""
    w = _const(vals, lambda: words_tensor(
        tag_words(vals) if isinstance(vals, bytes) else np.array(vals, np.uint32)), device)
    return w.expand(*lead, w.shape[0])


def initial_state(m: int, lead, device) -> torch.Tensor:
    """The chain's first state, SHA256(label ‖ be32(m)), as (*lead, 8) words."""
    state0 = hashlib.sha256(FS256_LABEL + m.to_bytes(4, "big")).digest()
    return _words(tuple(int(x) for x in np.frombuffer(state0, ">u4")), lead, device)


def affine_words(curve, pts: torch.Tensor) -> torch.Tensor:
    """Points (..., k, C, L), Montgomery form → their affine coordinates as
    big-endian words (..., k·2·L), in the order x_1, y_1, x_2, y_2, ....
    One Fermat inversion of every Z (one launch; 0 → 0 for the Weierstrass
    identity), one product back to plain form and one for both coordinates."""
    fp = curve.fp
    zi = fp.from_mont(fp.inv(pts[..., 2, :]))                  # plain Z⁻¹
    xy = fp.mul(pts[..., :2, :], zi[..., None, :])             # plain x, y
    return field_be_words(fp, xy).reshape(*pts.shape[:-3], -1)


def absorb_words(state: torch.Tensor, tag4: bytes, coords: torch.Tensor) -> torch.Tensor:
    """state = SHA256(state ‖ tag4 ‖ coords) over (..., 8) states."""
    lead = state.shape[:-1]
    msg = torch.cat([state, _words(tag4, lead, state.device), coords], dim=-1)
    return sha256_words(msg, 4 * msg.shape[-1])


def absorb_points(curve, state: torch.Tensor, tag4: bytes, pts: torch.Tensor) -> torch.Tensor:
    """state = SHA256(state ‖ tag4 ‖ x_1 ‖ y_1 ‖ ...) for points (..., k, C, L)."""
    return absorb_words(state, tag4, affine_words(curve, pts))


def counter(base, c: int):
    """Challenge number c of transcripts whose counters stood at `base`
    ((..., 1) int32, or None for 0)."""
    return c if base is None else base + c


def challenge_mont(fn, state: torch.Tensor, tag4: bytes, count):
    """Counter-tagged challenge: (new state, challenge in Montgomery form
    (..., 8)). `count` is the challenge's number, an int or (..., 1) int32
    per transcript. The state advances over "chal" ‖ tag4 ‖ be32(count); the
    challenge is the 512-bit SHA256(state ‖ 1) ‖ SHA256(state ‖ 2), both
    halves one launch over the 2·K messages, reduced into the scalar field;
    0 maps to 1."""
    lead, dev = state.shape[:-1], state.device
    count = (_words((count,), lead, dev) if isinstance(count, int)
             else count.expand(*lead, 1))
    msg = torch.cat([state, _words(b"chal", lead, dev), _words(tag4, lead, dev), count],
                    dim=-1)
    state = sha256_words(msg, 4 * msg.shape[-1])
    halves = torch.cat([state[..., None, :].expand(*lead, 2, 8),
                        _words((1, 2), lead, dev)[..., None]], dim=-1)   # (..., 2, 9)
    d = sha256_words(halves, 36).reshape(*lead, 16)
    e = digest_to_field_mont(fn, d)
    return state, fn.select(fn.is_zero(e), fn.one(dev).expand_as(e), e)


def fs256_replay(curve, m: int, V, A, L_vec, R_vec, Aw, B):
    """The verifier's challenges of K proofs, derived on the card exactly as
    the host twin derives them from fresh transcripts, with no host decode
    or hash. V (K, m, C, L); A, Aw, B (K, C, L); L_vec, R_vec (K, logn, C,
    L). Returns Montgomery (y (K, 8), z (K, 8), es (K, logn, 8), e_final
    (K, 8)). Every absorbed point goes to affine in one conversion, then
    each absorb takes its static slice."""
    fn = curve.fn
    lead, dev = A.shape[:-2], A.device
    logn = L_vec.shape[-3]
    k = m + 3 + 2 * logn
    pts = torch.cat([V, A[..., None, :, :], L_vec, R_vec, Aw[..., None, :, :],
                     B[..., None, :, :]], dim=-3)
    cw = affine_words(curve, pts).reshape(*lead, k, -1)

    def rows(sel):
        return cw[..., sel, :].reshape(*lead, -1)

    state = absorb_words(initial_state(m, lead, dev), b"stmt", rows(slice(0, m + 1)))
    state, y = challenge_mont(fn, state, b"y   ", 1)
    state, z = challenge_mont(fn, state, b"z   ", 2)
    es = []
    for r in range(logn):
        state = absorb_words(state, b"LR  ", rows([m + 1 + r, m + 1 + logn + r]))
        state, e = challenge_mont(fn, state, b"e   ", r + 3)
        es.append(e)
    state = absorb_words(state, b"AB  ", rows(slice(k - 2, k)))
    _, ef = challenge_mont(fn, state, b"ef  ", logn + 3)
    es_m = torch.stack(es, dim=-2) if es else y.new_zeros(*lead, 0, fn.L)
    return y, z, es_m, ef


def wip_prove_fs256_batched(curve, a, b, power_of_y, alpha, G, H, g, h, state,
                            dLs_m, dRs_m, r_m, s_m, delta_m, eta_m, base=None):
    """The sound fold of K proofs with its challenges drawn on the card
    (fs256.py:201-320): protocol/wip.py's fold, each round's e derived from
    (L, R) and the final one from (A, B) by the transcript chain on the
    (K, 8) states. `state` is the chain after the statement's y and z;
    `base` (K, 1) the transcripts' counters before y, or None for 0. ŷ is
    inverted once up front, each round's e by one Fermat inversion. Returns
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
            state = absorb_points(curve, state, b"LR  ", LR)
            state, e_m = challenge_mont(fn, state, b"e   ", counter(base, r + 3))
            e_inv = fn.inv(e_m)
            return e_m, e_inv, fn.mul(e_m, e_m), fn.mul(e_inv, e_inv)

    def final_challenge(AB):
        nonlocal state
        with record_function("bpp::fs256_challenge"):
            state = absorb_points(curve, state, b"AB  ", AB)
            state, ef_m = challenge_mont(fn, state, b"ef  ", counter(base, logn + 3))
            return ef_m

    out = fold(curve, a, b, power_of_y, alpha, G, H, g, h, dLs_m, dRs_m,
               r_m, s_m, delta_m, eta_m, ynhat_invs, round_challenge, final_challenge)
    return (*out, state)
