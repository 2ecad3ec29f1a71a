"""Kernel A: the Mamba-2 SSD chunked scan (prefill), csrc/ssd_scan.cu.

Replaces musicgen_tpu/ops/pallas_ssd.py `ssd_chunked_pallas` (its
`_ssd_kernel`). The plain version is ops/ssm.ssd_chunked: x (B,T,H,P), dt
(B,T,H), A (H,), B and C (B,T,G,N), all f32 -> y (B,T,H,P) and the final
state (B,H,P,N) from a zero state, P = N = 64, H % G == 0.

What bounds it on an H100 is the bytes (x read, y written: 79 MB at the
prefill's (2, 2304, 32, 64, 64), 0.024 ms at 3.35 TB/s), not the
recurrence's f32 work (0.015 ms as three TF32 passes). The TPU kernel
carried the state along a sequential grid axis, which left half the card
idle and the chunks in a row; here the chunks run in parallel over the
whole card in two launches, at the cost of a scratch of end states and a
second pass over y (about 226 MB moved in all):

1. one block a (batch, head, chunk of CHUNK = 64 steps), 2,304 at the
   prefill: the chunk's cumsum of dt*A, its output within the chunk and its
   own end state, into a scratch (B, NC, H, P, N) of `torch.empty`;
2. one block a (batch, head, PASS_ROWS state rows): the chunks in order,
   the state h_{c+1} = exp(cum_last,c) h_c + S_c carried in registers, the
   inter-chunk term exp(cum_t) C_t . h_c added into y, the final state.

The products run on the tensor cores as 3xTF32 (each operand split into a
TF32 high part and a TF32 remainder; three passes with f32 sums), about
f32 accuracy: one TF32 pass would sit near TOL_F32. `scan_partitioned`
writes this decomposition out in plain PyTorch, with the split emulated,
and `scan_geometry` the launches; the CPU tests hold both to the JAX
package. Every sum has a fixed order and no (b, h) pair reads another's
values: the same bits on every call and at any batch size.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .build import check, load_library, refuse_grad, stream_ptr
from .ssm import ssd_chunked

KERNEL_DIM = 64  # headdim P == d_state N (csrc/ssd_scan.cu D)
CHUNK = 64  # Q, steps a block of launch 1
THREADS = 128  # a block, in both launches
PASS_ROWS = 16  # PS, state rows a block of launch 2
STAGES = 3  # launch 2's ring of chunks in flight
# Dynamic shared memory a block: launch 1 the x, B and C tiles (rows of 68
# floats) and three vectors of Q; launch 2 STAGES x (C tile, S_c slice, y
# slice, cumsum), rows of 72, 72 and 24 floats (csrc/ssd_scan.cu).
CHUNK_SMEM = 4 * (3 * CHUNK * (KERNEL_DIM + 4) + 3 * CHUNK)
PASS_SMEM = 4 * STAGES * (CHUNK * (KERNEL_DIM + 8) + PASS_ROWS * (KERNEL_DIM + 8) + CHUNK * (PASS_ROWS + 8) + CHUNK)
MAX_GRID_YZ = 65535


class Geometry(NamedTuple):
    """Kernel A's two launches for (B, T, H, G): NC chunks, launch 1's grid
    (NC, H, B) and launch 2's (P / PASS_ROWS, H, B) of THREADS threads, each
    launch's dynamic shared memory a block, and the scratch shapes: the
    chunks' end states (B, NC, H, P, N) and cumsums (B, H, NC * Q)."""
    chunks: int
    chunk_grid: Tuple[int, int, int]
    pass_grid: Tuple[int, int, int]
    threads: int
    chunk_smem: int
    pass_smem: int
    states: Tuple[int, int, int, int, int]
    cum: Tuple[int, int, int]

    @property
    def scratch_bytes(self) -> int:
        n = 1
        for d in self.states:
            n *= d
        return 4 * (n + self.cum[0] * self.cum[1] * self.cum[2])


def scan_geometry(bsz: int, t: int, heads: int, groups: int, p: int = KERNEL_DIM, n: int = KERNEL_DIM) -> Geometry:
    """The launches for x (bsz, t, heads, p) and B, C (bsz, t, groups, n).
    Raises ValueError for a shape the kernel does not take: P or N other
    than 64, G not dividing H, an empty or too large dimension."""
    if p != KERNEL_DIM or n != KERNEL_DIM:
        raise ValueError(f"ssd_scan kernel needs headdim = d_state = {KERNEL_DIM}, got {p}, {n}")
    if min(bsz, t, heads, groups) < 1:
        raise ValueError(f"ssd_scan: empty shape (B, T, H, G) = ({bsz}, {t}, {heads}, {groups})")
    if heads % groups:
        raise ValueError(f"ngroups {groups} does not divide nheads {heads}")
    if max(bsz, heads) > MAX_GRID_YZ:
        raise ValueError(f"ssd_scan kernel: batch {bsz} or heads {heads} over {MAX_GRID_YZ}")
    nc = -(-t // CHUNK)
    return Geometry(nc, (nc, heads, bsz), (p // PASS_ROWS, heads, bsz), THREADS, CHUNK_SMEM, PASS_SMEM,
                    (bsz, nc, heads, p, n), (bsz, heads, nc * CHUNK))


def chunk_block(bx: int, by: int, bz: int) -> Tuple[int, int, int]:
    """(b, h, chunk) of launch 1's block (bx, by, bz), as the kernel reads
    its blockIdx."""
    return bz, by, bx


def pass_block(bx: int, by: int, bz: int) -> Tuple[int, int, range]:
    """(b, h, state rows p) of launch 2's block (bx, by, bz)."""
    return bz, by, range(bx * PASS_ROWS, (bx + 1) * PASS_ROWS)


def kernel_geometry() -> Tuple[int, ...]:
    """The kernel's own constants, read from the built library (on the
    card): Q, THREADS, launch 1's and launch 2's shared memory, PASS_ROWS,
    STAGES."""
    lib = load_library()
    out = (ctypes.c_int * 6)()
    check(lib, lib.mg_ssd_scan_geometry(ctypes.addressof(out)), "ssd_scan geometry")
    return tuple(out)


def tf32(v: torch.Tensor) -> torch.Tensor:
    """v with the low 13 of its 23 mantissa bits cleared: what the tensor
    cores read of an f32 operand as TF32."""
    return (v.contiguous().view(torch.int32) & -8192).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32 products: a = a_hi + a_lo, b likewise,
    each part TF32; a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def scan_partitioned(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor, C: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's decomposition in plain PyTorch, any T (the last chunk
    zero-filled), its products in emulated 3xTF32. Launch 1, per (b, h,
    chunk): the cumsum, y_diag = ((C B^T) o L)(dt x), the end state S_c.
    Launch 2, per (b, h) in chunk order: y += exp(cum_t) C_t . h_c, then
    h_{c+1} = exp(cum_last) h_c + S_c. Same contract as ssd_chunked."""
    b, t, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    nc = -(-t // CHUNK)
    pad = nc * CHUNK - t

    def chunks(v, heads):  # (B, T, heads, d) -> (B, H, NC, Q, d)
        v = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
        v = v.reshape(b, nc, CHUNK, heads, v.shape[-1]).permute(0, 3, 1, 2, 4)
        return v.repeat_interleave(h // heads, dim=1)

    x_c, B_c, C_c = chunks(x, h), chunks(Bmat, g), chunks(C, g)
    dt_c = chunks(dt[..., None], h)[..., 0]  # (B, H, NC, Q)
    cum = torch.cumsum(dt_c * A.float()[None, :, None, None], dim=-1)
    xdt = x_c * dt_c[..., None]

    # Launch 1.
    causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=x.device).tril()
    scores = mm3(C_c, B_c.transpose(-1, -2))
    m = torch.where(causal, scores * torch.exp(cum[..., :, None] - cum[..., None, :]), torch.zeros_like(scores))
    y_diag = mm3(m, xdt)
    w = torch.exp(cum[..., -1:] - cum)
    ends = mm3((xdt * w[..., None]).transpose(-1, -2), B_c)  # (B, H, NC, P, N)

    # Launch 2.
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    y_off = []
    for c in range(nc):
        y_off.append(mm3(C_c[:, :, c], state.transpose(-1, -2)) * torch.exp(cum[:, :, c, :, None]))
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] + ends[:, :, c]
    y = y_diag + torch.stack(y_off, dim=2)
    return y.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h, p)[:, :t], state


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """a contiguous and 16-byte aligned (the kernel's cp.async rows)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def ssd_scan(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, T, G, N)
    C: torch.Tensor,  # (B, T, G, N)
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan from a zero state. Returns (y (B,T,H,P), final_state (B,H,P,N)).

    CPU tensors take the plain version at `chunk` (which needs T % chunk ==
    0); CUDA tensors launch the kernel, which takes any T in chunks of
    CHUNK whatever `chunk` says (the function does not depend on it), and
    which has no backward: under grad mode it refuses inputs that require
    grad."""
    if not x.is_cuda:
        return ssd_chunked(x, dt, A, Bmat, C, chunk=chunk)
    refuse_grad("ssd_scan (kernel A)", x, dt, A, Bmat, C)
    b, t, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    geo = scan_geometry(b, t, h, g, p, n)
    if dt.shape != (b, t, h) or A.shape != (h,) or Bmat.shape != (b, t, g, n) or C.shape != Bmat.shape:
        raise ValueError("ssd_scan: inconsistent shapes")
    args = [x, dt, A, Bmat, C]
    for a in args:
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError("ssd_scan: all inputs must be float32 on one CUDA device")
    x, dt, A, Bmat, C = (_aligned(a) for a in args)
    y = torch.empty_like(x)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    ends = torch.empty(geo.states, dtype=torch.float32, device=x.device)
    cum = torch.empty(geo.cum, dtype=torch.float32, device=x.device)
    lib = load_library()
    err = lib.mg_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
        ends.data_ptr(), cum.data_ptr(), b, t, h, g, p, n, stream_ptr(x),
    )
    check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
