"""Public key (generator set) on a device, with cached fixed-base tables.

Port of bulletproofsplus_tpu/protocol/publickey.py:17-122 and :141-206.
`new`: g = base point, h = 2g, G_i = 3(i+1)g, H_i = 5(i+1)g (the
reference's small multiples, publickey.rs:23-39, deliberately insecure and
kept for parity). `new_secure`: hash-derived generators with unknown
discrete logs (`hash_to_point`, try-and-increment over SHA-512; the JAX
package's `_sqrt_mod` is WeierstrassHost.sqrt here, both curves' p being
3 mod 4). Both are computed on the curve's host arithmetic (curves/host.py)
in Python ints (one shared inversion back to affine) and uploaded; `fixed_tables`
builds the window tables of msm/fixed.py on the device once per (pk, mn),
or over a mesh axis one table a device, each over its slice of the
generators.
`commitment` (:124-138) is the committer's host step, as in the JAX package:
v·g + γ·h in Python ints, encoded onto the key's device.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

from ..device import entry_device


@dataclasses.dataclass
class PublicKey:
    """Generator set of one curve backend: tensors (C, L) and (length, C, L),
    C = curve.COORDS."""

    curve: object
    g: torch.Tensor
    h: torch.Tensor
    G_vec: torch.Tensor
    H_vec: torch.Tensor
    _fb_tables: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)
    _gh_proj: tuple = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def new(cls, curve, length: int, device=None) -> "PublicKey":
        """Small-multiple generators (publickey.rs:23-39), on `device`
        (default: the CUDA card; pass "cpu" for the CPU)."""
        device = entry_device(device)
        hc = curve.host
        g = hc.lift(hc.base)
        three, five = hc.mul(g, 3), hc.mul(g, 5)
        G, H = [three], [five]
        for _ in range(length - 1):
            G.append(hc.add(G[-1], three))
            H.append(hc.add(H[-1], five))
        pts = hc.to_affine([g, hc.add(g, g)] + G[:length] + H[:length])
        enc = curve.encode_points(pts, device)
        return cls(curve=curve, g=enc[0], h=enc[1], G_vec=enc[2:2 + length],
                   H_vec=enc[2 + length:])

    @classmethod
    def new_secure(cls, curve, length: int, label: bytes = b"bpp-tpu-gens",
                   device=None) -> "PublicKey":
        """Hash-derived generators (the JAX package's secure mode, absent
        from the reference): point i of [g, h, G_0.., H_0..] is
        hash_to_point(curve, label, i). On `device` (default: the CUDA
        card; pass "cpu" for the CPU)."""
        device = entry_device(device)
        pts = curve.host.to_affine([hash_to_point(curve, label, i)
                                    for i in range(2 * length + 2)])
        enc = curve.encode_points(pts, device)
        return cls(curve=curve, g=enc[0], h=enc[1], G_vec=enc[2:2 + length],
                   H_vec=enc[2 + length:])

    @property
    def length(self) -> int:
        return self.G_vec.shape[0]

    @property
    def device(self) -> torch.device:
        return self.g.device

    def prefix(self, mn: int) -> "PublicKey":
        """The first mn generators (the reference accepts longer sets and
        uses their prefix, errors.rs:37-41); shares this key's table cache."""
        if self.length == mn:
            return self
        return PublicKey(self.curve, self.g, self.h, self.G_vec[:mn],
                         self.H_vec[:mn], self._fb_tables, self._gh_proj)

    def commitment(self, v: int, gamma: int) -> torch.Tensor:
        """Pedersen commitment v·g + γ·h (publickey.rs:50-52): a (C, L) point
        on the key's device, computed on the host."""
        hc = self.curve.host
        if self._gh_proj is None:
            g, h = self.curve.decode_points(torch.stack([self.g, self.h]))
            self._gh_proj = (hc.lift(g), hc.lift(h))
        g, h = self._gh_proj
        V = hc.add(hc.mul(g, v), hc.mul(h, gamma))
        return self.curve.encode_points(hc.to_affine([V]), self.device)[0]

    def fixed_tables(self, mn: int, devices=None):
        """Window tables over [G_vec[:mn] ‖ H_vec[:mn]], built on first use:
        unsigned when it fits the budget of msm.fixed.fixed_base_mode, else
        the half-size signed table; None when neither fits (verify then runs
        the generator lanes on the ladder).

        With `devices` (a mesh axis of P devices, P dividing 2mn), the list
        of P tables: table i over generators [i·2mn/P, (i+1)·2mn/P), built on
        devices[i] and cached per (mn, device, slice). The budget decision
        is taken on the whole table, as the JAX package takes it
        (batch.py:318), so a mesh never changes which flavor a key uses."""
        from ..msm.fixed import (
            fixed_base_mode,
            precompute_slice_tables,
            precompute_tables,
            precompute_tables_signed,
        )

        if devices is not None and len(devices) == 1 and torch.device(devices[0]) == self.device:
            t = self.fixed_tables(mn)        # the one slice is the key's own table
            return None if t is None else [t]
        if devices is None:
            t = self._fb_tables.get(mn)
            if t is None:
                mode = fixed_base_mode(self.curve, 2 * mn)
                if mode is None:
                    return None
                build = precompute_tables if mode == "unsigned" else precompute_tables_signed
                t = build(self.curve, torch.cat([self.G_vec[:mn], self.H_vec[:mn]]))
                self._fb_tables[mn] = t
            return t
        P = len(devices)
        if (2 * mn) % P:
            raise ValueError("the mesh axis must divide the 2mn generators")
        mode = fixed_base_mode(self.curve, 2 * mn)
        if mode is None:
            return None
        per = 2 * mn // P
        keys = [(mn, str(d), i * per, (i + 1) * per) for i, d in enumerate(devices)]
        missing = [i for i, k in enumerate(keys) if k not in self._fb_tables]
        if missing:
            built = precompute_slice_tables(
                self.curve, torch.cat([self.G_vec[:mn], self.H_vec[:mn]]),
                [torch.device(d) for d in devices], missing, signed=mode == "signed")
            self._fb_tables.update((keys[i], t) for i, t in zip(missing, built))
        return [self._fb_tables[k] for k in keys]


def hash_to_point(curve, label: bytes, index: int):
    """Try-and-increment hash to the curve's prime-order group, as a host
    projective point (publickey.py:141-178): the candidate
    SHA-512(label ‖ "|" ‖ name ‖ "|index|ctr") mod p is an x (Weierstrass,
    with the smaller of ±y) or a y (Edwards, with the even x), skipped
    when no point has it; the Edwards cofactor 8 and the bls12-381 G1
    cofactor are cleared, skipping a candidate that lands on the identity."""
    hc = curve.host
    p = hc.p
    ctr = 0
    while True:
        digest = hashlib.sha512(
            label + b"|" + curve.name.encode() + b"|%d|%d" % (index, ctr)).digest()
        cand = int.from_bytes(digest, "big") % p
        ctr += 1
        if curve.COORDS == 3:
            y = hc.sqrt((cand * cand % p * cand + hc.b) % p)
            if y is None:
                continue
            P = hc.lift((cand, min(y, p - y)))
            if hc.cofactor != 1:
                P = hc.mul(P, hc.cofactor)
        else:
            try:
                x = hc.recover_x(cand, 0)
            except ValueError:
                continue
            P = hc.mul(hc.lift((x, cand)), 8)
        if not hc.is_identity(P):
            return P
