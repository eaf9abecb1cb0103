"""SHA-256 over word tensors and the field packing around it: the device half
of the fs256 Fiat-Shamir transcript (protocol/fs256.py).

Port of bulletproofsplus_tpu/hashers_device.py: `IV`, `_K`, `padding_words`
(:108), `sha256_words` (:123), `tag_words` (:136), `field_nbytes` (:153),
`field_be_words` (:171) and `digest_to_field_mont` (:209). Messages are
word-aligned and of a length known when the call is made; a word is a
big-endian uint32 held, as everywhere in the port, as the int32 bit pattern
of an int32 tensor. The same byte protocol runs on the host in
transcript.py::Fs256Transcript (hashlib).

`sha256_words` launches the SHA-256 kernel (csrc/sha256.cu, one thread a
message) on a CUDA tensor and runs `sha256_words_plain`, a torch
transcription of the JAX package's compression (:58-105) in int64 words
masked to 32 bits, on a CPU tensor; `sha256_words.launches` counts launches.
The port's limbs are 32-bit little-endian words, so a coordinate's
big-endian words are its plain-form limbs reversed: the JAX package's nibble
gather (:160-182), which serves its 12-bit limbs, has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import kernels
from .fields.spec import int_to_words, ints_to_tensor

# FIPS 180-4 §4.2.2 round constants and §5.3.3 initial hash value
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def padding_words(msg_bytes: int) -> np.ndarray:
    """FIPS 180-4 §5.1.1 padding of a word-aligned message of msg_bytes
    bytes: the uint32 words to append (0x80…, zeros, the 64-bit bit length)."""
    assert msg_bytes % 4 == 0
    nblocks = -(-(msg_bytes + 1 + 8) // 64)
    pad = bytearray(nblocks * 64 - msg_bytes)
    pad[0] = 0x80
    pad[-8:] = (msg_bytes * 8).to_bytes(8, "big")
    return np.frombuffer(bytes(pad), dtype=">u4").astype(np.uint32)


def tag_words(tag: bytes) -> np.ndarray:
    """A static ASCII tag as uint32 words (4-byte aligned: tags are padded
    with spaces where they are defined)."""
    assert len(tag) % 4 == 0
    return np.frombuffer(tag, dtype=">u4").astype(np.uint32)


def words_tensor(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words → their int32 bit patterns as a tensor on `device`."""
    return torch.from_numpy(np.asarray(words, dtype=np.uint32).view(np.int32).copy()).to(device)


# -- plain version ---------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _compress_plain(state, block):
    """One compression over int64 words in [0, 2^32): state a list of 8
    (...) tensors, block a list of 16; returns the new state list."""
    w = list(block)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + int(_K[t]) + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + S0 + maj) & MASK32, a, b, c, (d + t1) & MASK32,
                                  e, f, g)
    return [(x + y) & MASK32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words_plain(words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """Plain PyTorch SHA-256: (..., msg_bytes/4) int32 words → (..., 8)
    int32 digest words, the compressions of the JAX package's
    sha256_compress/sha256_blocks in int64 masked to 32 bits."""
    lead = words.shape[:-1]
    pad = torch.from_numpy(padding_words(msg_bytes).astype(np.int64)).to(words.device)
    full = torch.cat([words.to(torch.int64) & MASK32, pad.expand(*lead, pad.shape[0])], dim=-1)
    state = [torch.full(lead, int(v), dtype=torch.int64, device=words.device) for v in IV]
    for i in range(full.shape[-1] // 16):
        state = _compress_plain(state, full[..., 16 * i:16 * (i + 1)].unbind(-1))
    out = torch.stack(state, dim=-1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


# -- kernel wrapper ----------------------------------------------------------


def sha256_words(words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """SHA-256 of each row of (..., msg_bytes/4) int32 words (a word-aligned
    message of msg_bytes bytes) → (..., 8) int32 digest words. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, the leading
    axes its batch of messages, or raises."""
    if msg_bytes % 4 or words.shape[-1] != msg_bytes // 4:
        raise ValueError(f"sha256_words: {words.shape[-1]} words do not hold "
                         f"{msg_bytes} word-aligned bytes")
    if words.device.type == "cpu":
        return sha256_words_plain(words, msg_bytes)
    kernels.check_operands("sha256_words", (words, torch.int32))
    lead = words.shape[:-1]
    B = lead.numel()
    x = kernels.aligned(words.reshape(B, msg_bytes // 4))
    out = torch.empty((*lead, 8), dtype=torch.int32, device=words.device)
    if B:
        kernels.launch("bpp_sha256_words", x.data_ptr(), out.data_ptr(), B, msg_bytes,
                       device=words.device)
        sha256_words.launches += 1
    return out


sha256_words.launches = 0


# -- field elements <-> words --------------------------------------------------


def field_nbytes(ops) -> int:
    """Canonical big-endian byte length of a field element (32 for the
    255/256-bit moduli, 48 for bls12-381's Fq)."""
    return (ops.p.bit_length() + 7) // 8


def field_be_words(ops, x: torch.Tensor) -> torch.Tensor:
    """Plain canonical limbs (..., L) → big-endian words (..., nbytes/4):
    the limbs reversed, since every port field's canonical length is its
    L words."""
    if field_nbytes(ops) != 4 * ops.L:
        raise ValueError(f"{ops.spec.name}: {field_nbytes(ops)} bytes are not {ops.L} words")
    return x.flip(-1)


_DIGEST_CONSTS: dict = {}


def _digest_mont_consts(fn, device) -> torch.Tensor:
    """C_j = 2^{32·(15−j)}·R² mod p, (16, L): fn.mul(w_j, C_j) is the
    Montgomery form of w_j·2^{32·(15−j)} (R = 2^(32L), the port's own)."""
    key = (fn.spec.name, str(device))
    if key not in _DIGEST_CONSTS:
        p, r2 = fn.p, fn.spec.r2_mod_p
        _DIGEST_CONSTS[key] = ints_to_tensor(
            [pow(2, 32 * (15 - j), p) * r2 % p for j in range(16)], device, fn.L)
    return _DIGEST_CONSTS[key]


def digest_to_field_mont(fn, words: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 digest words, big-endian significance → the
    Montgomery form of Σ_j w_j·2^{32(15−j)} mod p, (..., L): 16 products
    (one K1 launch) and one field sum. 2^512 is far above p, so the
    reduction has negligible bias."""
    wl = torch.nn.functional.pad(words[..., None], (0, fn.L - 1))     # plain w_j
    return fn.sum(fn.mul(wl, _digest_mont_consts(fn, words.device)), axis=-2)


# -- the fs256 chain ------------------------------------------------------------


class Step(NamedTuple):
    """One step of an fs256 chain: absorb rows [row0, row0 + nrows) of a
    transcript's coordinate words under the 4-byte tag `absorb` (None: no
    absorb), then draw `challenges`, each a (4-byte tag, counter offset):
    challenge number base + offset, base being the transcript's counter
    before the chain."""
    absorb: Optional[bytes]
    rows: tuple
    challenges: tuple


MAX_STEPS = 64          # csrc/fs256_chain.cu: a schedule's steps
MAX_CHAL = 2            # and a step's challenges


@functools.lru_cache(maxsize=256)
def schedule_words(schedule: tuple):
    """A schedule (a tuple of Step) as the kernel's argument: per step
    absorb (0/1), tag, row0, nrows, the number of challenges, then (tag,
    offset) per challenge, MAX_CHAL pairs."""
    if len(schedule) > MAX_STEPS:
        raise ValueError(f"an fs256 chain takes at most {MAX_STEPS} steps")
    words = []
    for step in schedule:
        if len(step.challenges) > MAX_CHAL:
            raise ValueError(f"a chain step draws at most {MAX_CHAL} challenges")
        tag = int(tag_words(step.absorb)[0]) if step.absorb is not None else 0
        words += [int(step.absorb is not None), tag, *step.rows, len(step.challenges)]
        for i in range(MAX_CHAL):
            ctag, off = step.challenges[i] if i < len(step.challenges) else (b"    ", 0)
            words += [int(tag_words(ctag)[0]), off]
    return (ctypes.c_uint32 * len(words))(*words)


@functools.lru_cache(maxsize=None)
def _chain_field(spec):
    """The kernel's field argument: p, -p^-1 mod 2^32, c_hi = 2^256·R² mod
    p and c_lo = R² mod p (the digest halves' weights; R = 2^256), R mod p."""
    p, r2 = spec.modulus, spec.r2_mod_p
    words = (spec.p_words + [spec.n0inv] + int_to_words((1 << 256) * r2 % p, 8)
             + int_to_words(r2, 8) + int_to_words(spec.r_mod_p, 8))
    return (ctypes.c_uint32 * len(words))(*words)


def _check_chain(fn, state, base, cw, schedule) -> int:
    """Shapes of an fs256 chain call; returns its number of challenges."""
    K = state.shape[0]
    if fn.L != 8:
        raise ValueError("fs256 challenges are 8-word scalars")
    if state.shape != (K, 8) or cw.dim() != 3 or cw.shape[0] != K:
        raise ValueError(f"fs256_chain: state {tuple(state.shape)} and coordinate words "
                         f"{tuple(cw.shape)} are not (K, 8) and (K, rows, words)")
    if base is not None and base.shape != (K,):
        raise ValueError(f"fs256_chain: counters {tuple(base.shape)} are not ({K},)")
    for step in schedule:
        r0, nr = step.rows
        if r0 < 0 or nr < 0 or r0 + nr > cw.shape[1]:
            raise ValueError(f"fs256_chain: rows {step.rows} outside {cw.shape[1]} rows")
    return sum(len(step.challenges) for step in schedule)


def fs256_chain_plain(fn, state, base, cw, schedule):
    """The chain composed from the plain SHA-256 and digest_to_field_mont:
    per absorb one hash of state ‖ tag ‖ rows, per challenge one of state ‖
    "chal" ‖ tag ‖ be32(counter), one of both halves and the 16-product
    reduction, 0 mapped to 1, on fn's plain field ops (no launch on any
    device). Returns (challenges (K, S, 8), state (K, 8))."""
    fn = fn.plain
    K, dev = state.shape[0], state.device
    ctr = (base.to(torch.int64) if base is not None
           else torch.zeros(K, dtype=torch.int64, device=dev))

    def tag(t):
        return words_tensor(tag_words(t), dev).expand(K, -1)

    halves = words_tensor(np.array([[1], [2]], np.uint32), dev).expand(K, 2, 1)
    out = []
    for step in schedule:
        if step.absorb is not None:
            r0, nr = step.rows
            msg = torch.cat([state, tag(step.absorb), cw[:, r0:r0 + nr].reshape(K, -1)], -1)
            state = sha256_words_plain(msg, 4 * msg.shape[-1])
        for ctag, off in step.challenges:
            count = ((ctr + off) & MASK32)[:, None]
            count = (count - ((count >> 31) << 32)).to(torch.int32)
            msg = torch.cat([state, tag(b"chal"), tag(ctag), count], -1)
            state = sha256_words_plain(msg, 44)
            d = sha256_words_plain(torch.cat([state[:, None].expand(K, 2, 8), halves], -1), 36)
            e = digest_to_field_mont(fn, d.reshape(K, 16))
            out.append(fn.select(fn.is_zero(e), fn.one(dev).expand_as(e), e))
    chal = torch.stack(out, 1) if out else state.new_zeros(K, 0, fn.L)
    return chal, state


def fs256_chain(fn, state, base, cw, schedule):
    """Run the fs256 chain `schedule` (a tuple of Step) over K transcripts:
    state (K, 8) int32 start states, base (K,) int32 counters before the
    chain or None for 0, cw (K, rows, words) int32 coordinate words (the
    absorbed points' big-endian affine words, a point a row). Returns
    (challenges (K, S, 8) in Montgomery form of fn's field, the final
    states (K, 8)). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (csrc/fs256_chain.cu) once, or raises."""
    nchal = _check_chain(fn, state, base, cw, schedule)
    if state.device.type == "cpu":
        return fs256_chain_plain(fn, state, base, cw, schedule)
    pairs = [(state, torch.int32), (cw, torch.int32)]
    if base is not None:
        pairs.append((base, torch.int32))
    kernels.check_operands("fs256_chain", *pairs)
    return _chain_launch(fn, state, base, cw, schedule, nchal)


def _chain_launch(fn, state, base, cw, schedule, nchal):
    K, dev = state.shape[0], state.device
    st = kernels.aligned(state)
    x = kernels.aligned(cw)
    b = None if base is None else base.contiguous()
    chal = torch.empty((K, nchal, 8), dtype=torch.int32, device=dev)
    out = torch.empty((K, 8), dtype=torch.int32, device=dev)
    if K:
        kernels.launch("bpp_fs256_chain", st.data_ptr(), 0 if b is None else b.data_ptr(),
                       x.data_ptr(), chal.data_ptr(), out.data_ptr(), K, cw.shape[1],
                       cw.shape[2], schedule_words(schedule), len(schedule),
                       _chain_field(fn.spec), device=dev)
        fs256_chain.launches += 1
    return chal, out


fs256_chain.launches = 0
