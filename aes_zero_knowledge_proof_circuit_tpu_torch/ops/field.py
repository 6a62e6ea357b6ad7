"""Montgomery field arithmetic over Fr and Fq on u32 limb tensors.

Counterpart of ops/field_f32.py `F32Ops` in the JAX package. An element is a
row of L little-endian u32 limbs (stored as int32) holding a*R mod p, fully
reduced below p:

    Fr: [.., 8],  R = 2^256        Fq: [.., 12], R = 2^384

Every op returns fully reduced limbs, so equality of values is equality of
rows. mul, add, sub, pow (and inv) and batch_inv run kernel K1
(csrc/fr_ops.cu) on CUDA tensors; on CPU tensors they run the plain PyTorch
versions below, which compute the same function in the same layout. The
plain versions work on 16-bit half-limbs, since PyTorch has no unsigned
32x32->64 multiply: every partial product and column sum stays below 2^53,
exact in int64 and in float64.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .field_params import Q_MOD, R_MOD

from .. import kernels
from ..utils import spans

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
# batch_inv's chunk of rows a thread runs through, and the chunks a block
# scans: the kernel's kChunk and kBlock (csrc/fr_ops.cu)
INV_CHUNK = 8
INV_BLOCK = 256


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 limb storage -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 limb storage (two's complement)."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def halves(x: torch.Tensor) -> torch.Tensor:
    """[.., L] u32 limbs -> [.., 2L] int64 16-bit half-limbs (low first)."""
    v = to_u32(x)
    return torch.stack([v & MASK16, v >> 16], dim=-1).reshape(
        *x.shape[:-1], 2 * x.shape[-1])


def from_halves(h: torch.Tensor) -> torch.Tensor:
    """[.., 2L] 16-bit half-limbs (each < 2^16) -> [.., L] int32 limbs."""
    h = h.reshape(*h.shape[:-1], h.shape[-1] // 2, 2)
    return from_u32(h[..., 0] | (h[..., 1] << 16))


def _normalize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Propagate (floor) carries until every column but the last lies in
    [0, 2^bits); the last column keeps the sign and the overflow."""
    x = x.clone()
    mask = (1 << bits) - 1
    while True:
        c = x[..., :-1] >> bits
        if not bool(c.any()):
            return x
        x[..., :-1] &= mask
        x[..., 1:] += c


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned, as the kernels' vector loads need
    (a copy only for a view that starts mid-vector)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def upload(host: torch.Tensor, device) -> torch.Tensor:
    """`host` on `device`; to a CUDA device from pinned memory on the
    current stream, without waiting for the card (the caching host
    allocator keeps the pinned copy until the copy has run), counted in
    `upload_bytes`."""
    spans.count("upload_bytes", spans.nbytes(host))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def table_built(device) -> None:
    """Wait, on a CUDA `device`, for its current stream to finish what it
    has queued. Called once a table is built and before it is cached: a
    cached table is read from every stream (`api.encrypt_batch` proves on
    two), and a reader on a stream other than the builder's would otherwise
    race the build."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _int_limbs(v: int, n: int, bits: int) -> List[int]:
    return [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]


class FieldOps:
    """Field engine for one prime; `fr_ops()` / `fq_ops()` hold the two."""

    def __init__(self, modulus: int, limbs: int, field_id: int):
        self.modulus = modulus
        self.L = limbs
        self.field_id = field_id          # the kernels' field selector
        self.R = 1 << (32 * limbs)
        self.R_mod = self.R % modulus
        self.R2 = self.R * self.R % modulus
        self.R3 = self.R2 * self.R % modulus
        self.R_inv = pow(self.R_mod, -1, modulus)
        self._p16 = _int_limbs(modulus, 2 * limbs, 16)
        self._p32 = _int_limbs(modulus, limbs, 32)
        self._nprime16 = _int_limbs((-pow(modulus, -1, self.R)) % self.R,
                                    2 * limbs, 16)
        self._consts: Dict[Tuple[str, str], torch.Tensor] = {}

    # -- constants -----------------------------------------------------------

    def const(self, name: str, device) -> torch.Tensor:
        """[1, L] constant rows on `device`: one (Montgomery 1), one_raw (the
        integer 1, for Montgomery -> standard), r2, r3, zero. For the plain
        versions: int64 modulus limbs with a spare top column (p16x [2L+1],
        p32x [L+1]), and float64 shift matrices (nprime_shifts [2L, 2L],
        p_shifts [2L, 4L+1]) whose row i holds the constant's 16-bit
        half-limbs from column i on, so that x @ it is the product's column
        sums (truncated at the width); low_weights [2L] = 2^(16 (j - 2L))."""
        key = (name, str(device))
        t = self._consts.get(key)
        if t is None:
            m_ = 2 * self.L
            vals = {"one": self.R_mod, "one_raw": 1, "r2": self.R2,
                    "r3": self.R3, "zero": 0}
            limbs = {"p16x": self._p16 + [0], "p32x": self._p32 + [0]}
            shifts = {"nprime_shifts": (self._nprime16, m_),
                      "p_shifts": (self._p16, 2 * m_ + 1)}
            if name in limbs:
                t = torch.tensor(limbs[name], dtype=torch.int64, device=device)
            elif name == "low_weights":
                t = torch.tensor([2.0 ** (16 * (j - m_)) for j in range(m_)],
                                 dtype=torch.float64, device=device)
            elif name in shifts:
                half_limbs, width = shifts[name]
                t = torch.zeros((m_, width), dtype=torch.float64)
                for i in range(m_):
                    n = min(m_, width - i)
                    t[i, i:i + n] = torch.tensor(half_limbs[:n],
                                                 dtype=torch.float64)
                t = t.to(device)
            else:
                t = self.from_ints([vals[name]], device, mont=False)
            table_built(device)
            self._consts[key] = t
        return t

    # -- host conversion ------------------------------------------------------

    def from_ints(self, values: Iterable[int], device, mont: bool = True,
                  non_blocking: bool = False) -> torch.Tensor:
        """Python ints -> [n, L] limbs (Montgomery form unless mont=False).
        non_blocking=True enqueues the copy to a CUDA device from pinned
        memory on the current stream, without waiting for the card."""
        p, nbytes = self.modulus, 4 * self.L
        if mont:
            raw = b"".join((int(v) % p * self.R_mod % p).to_bytes(nbytes, "little")
                           for v in values)
        else:
            raw = b"".join((int(v) % p).to_bytes(nbytes, "little")
                           for v in values)
        arr = np.frombuffer(raw, dtype="<u4").reshape(-1, self.L)
        if non_blocking:
            return upload(torch.from_numpy(arr.view(np.int32).copy()), device)
        with spans.wait("from_ints", upload=arr.nbytes):
            return torch.from_numpy(arr.view(np.int32).copy()).to(device)

    def to_ints(self, x: torch.Tensor, mont: bool = True) -> List[int]:
        """[.., L] limbs -> Python ints (values mod p, leaving Montgomery form
        unless mont=False), in one copy to the host."""
        with spans.wait("to_ints", readback=spans.nbytes(x)):
            host = x.detach().cpu()
        return self.host_ints(host.numpy(), mont)

    def host_ints(self, limbs: np.ndarray, mont: bool = True) -> List[int]:
        """to_ints of limbs already on the host."""
        arr = np.ascontiguousarray(limbs.reshape(-1, self.L)).view("<u4")
        out = [int.from_bytes(row.tobytes(), "little") for row in arr]
        if mont:
            return [v * self.R_inv % self.modulus for v in out]
        return [v % self.modulus for v in out]

    # -- plain PyTorch versions of K1 (any device) ----------------------------

    def plain_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod p, fully reduced: schoolbook product,
        m = (T mod R) * (-p^-1) mod R, (T + m p) / R, one conditional
        subtraction — on 16-bit half-limbs.

        The column sums are taken in float64, where they are exact: every
        term and every partial sum is an integer below 2^53 (a 16-bit by
        16-bit product is below 2^32, a column adds at most 2L of them; the
        products by the constants take columns below 2^22). The products by
        -p^-1 and p are matrix products with shifted copies of the
        constant's half-limbs."""
        a, b = torch.broadcast_tensors(a, b)
        m_ = 2 * self.L
        dev = a.device
        ha = halves(a).to(torch.float64)
        hb = halves(b).to(torch.float64)
        prod = torch.zeros(*ha.shape[:-1], 2 * m_ + 1, dtype=torch.float64,
                           device=dev)
        for i in range(m_):
            prod[..., i:i + m_].addcmul_(ha[..., i:i + 1], hb)
        # one carry pass bounds T's columns below 2^22 for the products below
        t = prod.to(torch.int64)
        carry = t[..., :-1] >> 16
        t[..., :-1] &= MASK16
        t[..., 1:] += carry
        m = _normalize((t[..., :m_].to(torch.float64)
                        @ self.const("nprime_shifts", dev)).to(torch.int64),
                       16)
        m[..., -1] &= MASK16                        # m mod R
        u = t.to(torch.float64) + m.to(torch.float64) @ self.const(
            "p_shifts", dev)                        # columns below 2^38
        # T + m p is a multiple of R = 2^(32 L), so its 2L low columns
        # weighed by 2^(16 (j - 2L)) sum to the integer k carried into the
        # high half; the float sum stays within 2^-26 of k, and rounding
        # recovers it
        k = torch.round(u[..., :m_] @ self.const("low_weights", dev))
        r = u[..., m_:].to(torch.int64)
        r[..., 0] += k.to(torch.int64)
        r = _normalize(r, 16)
        d = _normalize(r - self.const("p16x", dev), 16)
        res = torch.where((d[..., -1] < 0).unsqueeze(-1), r, d)
        return from_halves(res[..., :m_])

    def plain_add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        s = torch.cat([to_u32(a) + to_u32(b),
                       torch.zeros_like(a[..., :1], dtype=torch.int64)], -1)
        s = _normalize(s, 32)
        d = _normalize(s - self.const("p32x", a.device), 32)
        res = torch.where((d[..., -1] < 0).unsqueeze(-1), s, d)
        return from_u32(res[..., :self.L])

    def plain_sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        d = torch.cat([to_u32(a) - to_u32(b),
                       torch.zeros_like(a[..., :1], dtype=torch.int64)], -1)
        d = _normalize(d, 32)
        fix = _normalize(d + self.const("p32x", a.device), 32)
        res = torch.where((d[..., -1] < 0).unsqueeze(-1), fix, d)
        return from_u32(res[..., :self.L])

    def plain_pow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e rowwise by left-to-right square-and-multiply (0^e = 0 for
        e > 0)."""
        acc = self.const("one", a.device).expand(a.shape[0], self.L)
        for bit in bin(e)[2:]:
            acc = self.plain_mul(acc, acc)
            if bit == "1":
                acc = self.plain_mul(acc, a)
        return acc

    def plain_batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse (zeros map to zero) by Montgomery's trick in
        the kernel's chunks: zeros replaced by one, then _plain_inv_nonzero."""
        zero = self.is_zero(a)
        safe = self.select(zero, self.const("one", a.device).expand_as(a), a)
        return self.select(zero, torch.zeros_like(a),
                           self._plain_inv_nonzero(safe))

    def _plain_inv_nonzero(self, x: torch.Tensor) -> torch.Tensor:
        """Inverses of nonzero rows: running products inside chunks of
        INV_CHUNK rows (vectorised across chunks), the chunk totals inverted
        the same way (one Fermat exponentiation at the top), then each chunk
        swept backwards: x_j^-1 = (x_0 .. x_j)^-1 (x_0 .. x_(j-1))."""
        n, c = x.shape[0], INV_CHUNK
        if n == 1:
            return self.plain_pow(x, self.modulus - 2)
        m = -(-n // c)
        one = self.const("one", x.device)
        xs = torch.cat([x, one.expand(m * c - n, self.L)]).view(m, c, self.L)
        prefix = [xs[:, 0]]
        for j in range(1, c):
            prefix.append(self.plain_mul(prefix[-1], xs[:, j]))
        running = self._plain_inv_nonzero(prefix[-1])
        out = [None] * c
        for j in range(c - 1, 0, -1):
            out[j] = self.plain_mul(running, prefix[j - 1])
            running = self.plain_mul(running, xs[:, j])
        out[0] = running
        return torch.stack(out, dim=1).reshape(m * c, self.L)[:n]

    # -- K1 wrappers ------------------------------------------------------------

    def _check(self, x: torch.Tensor) -> None:
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != self.L:
            raise ValueError(
                f"expected [N, {self.L}] int32 limbs, got "
                f"{tuple(x.shape)} {x.dtype}")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {x.device}")
        kernels.check_device(x)

    def _operands(self, a: torch.Tensor, b: torch.Tensor):
        self._check(a)
        self._check(b)
        if a.device != b.device:
            raise ValueError(f"operands on {a.device} and {b.device}")
        na, nb = a.shape[0], b.shape[0]
        if na != nb and 1 not in (na, nb):
            raise ValueError(f"row counts {na} and {nb} do not broadcast")
        return max(na, nb)

    def _binop(self, kernel, plain, a, b):
        n = self._operands(a, b)
        if a.device.type == "cpu":
            return plain(a, b)
        a, b = aligned(a), aligned(b)
        out = torch.empty((n, self.L), dtype=torch.int32, device=a.device)
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, self.field_id,
               int(a.shape[0] == 1 and n > 1), int(b.shape[0] == 1 and n > 1))
        return out

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._binop(kernels.field_mul, self.plain_mul, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._binop(kernels.field_add, self.plain_add, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._binop(kernels.field_sub, self.plain_sub, a, b)

    def _exponent(self, e: int, device) -> torch.Tensor:
        """e's u32 limbs (low first) as an int32 tensor on `device`."""
        key = (f"exponent {e}", str(device))
        t = self._consts.get(key)
        if t is None:
            t = from_u32(torch.tensor(_int_limbs(e, -(-e.bit_length() // 32),
                                                 32), dtype=torch.int64)
                         ).to(device)
            table_built(device)
            self._consts[key] = t
        return t

    def pow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e rowwise, e >= 0: one launch of K1's pow on a CUDA tensor."""
        self._check(a)
        if e < 0:
            raise ValueError("negative exponent")
        if e == 0:
            return self.const("one", a.device).expand(a.shape[0],
                                                      self.L).clone()
        if a.device.type == "cpu":
            return self.plain_pow(a, e)
        a = aligned(a)
        out = torch.empty_like(a)
        kernels.field_pow(a.data_ptr(), out.data_ptr(),
                          self._exponent(e, a.device).data_ptr(),
                          e.bit_length(), a.shape[0], self.field_id)
        return out

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse of [N, L] (zeros map to zero), as
        F32Ops.batch_inv: Montgomery's trick with ONE Fermat inversion, in
        three launches of K1 on a CUDA tensor."""
        self._check(a)
        if a.device.type == "cpu":
            return self.plain_batch_inv(a)
        a = aligned(a)
        n = a.shape[0]
        out = torch.empty_like(a)
        if n == 0:
            return out
        blocks = -(-n // (INV_CHUNK * INV_BLOCK))
        ctot = a.new_empty((blocks * INV_BLOCK, self.L))   # chunk totals
        btot = a.new_empty((blocks, self.L))     # block totals, then inverses
        bpre = a.new_empty((blocks, self.L))     # their running products
        e = self.modulus - 2
        kernels.batch_inv(a.data_ptr(), out.data_ptr(), ctot.data_ptr(),
                          btot.data_ptr(), bpre.data_ptr(),
                          self.const("one", a.device).data_ptr(),
                          self._exponent(e, a.device).data_ptr(),
                          e.bit_length(), n, self.field_id)
        return out

    # -- compositions -----------------------------------------------------------

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(self.const("zero", a.device), a)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inverse, elementwise (0 maps to 0): one pow launch."""
        return self.pow(a, self.modulus - 2)

    def prefix_mul(self, a: torch.Tensor) -> torch.Tensor:
        """Inclusive running products along axis 0, as F32Ops._prefix_mul:
        a Hillis-Steele scan, round d multiplying rows [d, n) by rows
        [0, n - d) of the round before (ceil(log2 n) products)."""
        self._check(a)
        out, d = a, 1
        while d < a.shape[0]:
            out = torch.cat([out[:d], self.mul(out[:-d], out[d:])])
            d <<= 1
        return out

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.where(cond.unsqueeze(-1), a, b)

    def to_canonical_limbs(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery -> standard form limbs (the MSM scalar layout)."""
        return self.mul(a, self.const("one_raw", a.device))

    def from_small(self, vals: torch.Tensor) -> torch.Tensor:
        """Signed integer tensor [N] (|v| < 2^63) -> Montgomery limbs."""
        v = vals.to(torch.int64)
        mag = v.abs()
        raw = torch.zeros((v.shape[0], self.L), dtype=torch.int64,
                          device=v.device)
        raw[:, 0] = mag & MASK32
        raw[:, 1] = mag >> 32
        mont = self.mul(from_u32(raw), self.const("r2", v.device))
        return self.select(v < 0, self.neg(mont), mont)


@functools.lru_cache(maxsize=None)
def fr_ops() -> FieldOps:
    return FieldOps(R_MOD, 8, 0)


@functools.lru_cache(maxsize=None)
def fq_ops() -> FieldOps:
    return FieldOps(Q_MOD, 12, 1)
