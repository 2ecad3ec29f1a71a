"""Kernel H: the sLSTM recurrence of the prefill, csrc/slstm_scan.cu.

Replaces musicgen_tpu/ops/pallas_slstm.py `slstm_pallas` (its
`_slstm_kernel`), with the contract of ops/slstm.slstm_sequential, its plain
version: (wx (B, T, 4, H, DH), r (4, H, DH, DH), b (4, H, DH)) ->
(h (B, T, H, DH), final (h, c, n, m) each (B, H, DH)), all f32, from the
zero state, R in f32 as in the TPU kernel. The kernel computes in f32 FMA, so
it agrees with the plain scan to f32 rounding (sums in another order).

The kernel runs one thread-block cluster of CS blocks (ranks) a head and a
group of up to BR batch rows. Rank k owns the hidden units [k U, (k + 1) U),
U = DH / CS, with their four gate columns, keeps its slab of R_h in shared
memory for the whole sequence and pushes its slice of h_t into every rank
through distributed shared memory. `scan_geometry` gives the launch,
`pack_r_slabs` the slabs, and `scan_partitioned` is the partition written
out in plain PyTorch (the CPU tests hold it to the plain scan).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .build import check, load_library, refuse_grad, stream_ptr
from .slstm import SState, slstm_init_state, slstm_sequential

MAX_DH = 256  # the kernel's largest head width (one thread per K slice and quad of columns)
CLUSTER = 16  # CS where it divides DH (non-portable); else PORTABLE_CLUSTER
PORTABLE_CLUSTER = 8
ROWS = 8  # BR, batch rows a cluster
THREADS = 256
SMEM_LIMIT = 232448  # 227 KB of shared memory a block


class Geometry(NamedTuple):
    """One launch of kernel H: CS ranks a cluster, `rows` (BR) batch rows a
    group, `groups` row groups, the grid (CS, H, groups), THREADS threads a
    block and `smem` bytes of dynamic shared memory a block, of which `slab`
    are the rank's R."""
    cs: int
    rows: int
    groups: int
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    slab: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def smem_bytes(dh: int, cs: int, rows: int) -> int:
    """The block's dynamic shared memory: the slab (DH, 4U), two buffers of
    the K slices' partial sums (CS, rows, 4U) and two h buffers (rows, DH),
    f32 (csrc/slstm_scan.cu smem_bytes). Its 2 CS mbarriers are static."""
    u = dh // cs
    return 4 * (dh * 4 * u + 2 * 4 * rows * dh + 2 * rows * dh)


def refusal(bsz: int, t: int, heads: int, dh: int, cs: Optional[int] = None) -> Optional[str]:
    """Why the kernel does not take (B, T, H, DH) with clusters of `cs`
    ranks (scan_geometry's default where None), or None where it does: an
    empty dimension, DH > 256, 4 DH not a multiple of 32, a cluster that
    does not split DH, or a block's shared memory over the limit."""
    if min(bsz, t, heads, dh) < 1:
        return f"slstm_scan: empty shape (B, T, H, DH) = ({bsz}, {t}, {heads}, {dh})"
    if dh > MAX_DH or (4 * dh) % 32:
        return f"slstm_scan kernel needs DH <= {MAX_DH} and 4 DH a multiple of 32, got DH = {dh}"
    if cs is None:
        cs = CLUSTER if dh % CLUSTER == 0 else PORTABLE_CLUSTER
    if cs not in (PORTABLE_CLUSTER, CLUSTER) or dh % cs:
        return f"slstm_scan kernel: a cluster of {cs} ranks does not split DH = {dh}"
    smem = smem_bytes(dh, cs, min(bsz, ROWS))
    if smem + 16 * cs > SMEM_LIMIT:
        return f"slstm_scan kernel: {smem} B of shared memory a block is over {SMEM_LIMIT}"
    return None


def scan_geometry(bsz: int, t: int, heads: int, dh: int, cs: Optional[int] = None) -> Geometry:
    """The launch for (B, T, H, DH), with clusters of `cs` ranks (8 or 16;
    by default 16 where it divides DH, else 8). Raises ValueError with
    `refusal`'s reason for a shape the kernel does not take."""
    reason = refusal(bsz, t, heads, dh, cs)
    if reason is not None:
        raise ValueError(reason)
    if cs is None:
        cs = CLUSTER if dh % CLUSTER == 0 else PORTABLE_CLUSTER
    rows = min(bsz, ROWS)
    groups = -(-bsz // rows)
    return Geometry(cs, rows, groups, (cs, heads, groups), THREADS, smem_bytes(dh, cs, rows),
                    4 * dh * 4 * (dh // cs))


def launch_geometry(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, cs: Optional[int] = None) -> Geometry:
    """scan_geometry of the inputs, after checking that their shapes agree."""
    if wx.dim() != 5:
        raise ValueError(f"slstm_scan: wx must be (B, T, 4, H, DH), got {tuple(wx.shape)}")
    bsz, t, four, h, dh = wx.shape
    if four != 4 or tuple(r.shape) != (4, h, dh, dh) or tuple(b.shape) != (4, h, dh):
        raise ValueError(f"slstm_scan: inconsistent shapes wx {tuple(wx.shape)}, r {tuple(r.shape)}, "
                         f"b {tuple(b.shape)}")
    return scan_geometry(bsz, t, h, dh, cs)


def pack_r_slabs(r: torch.Tensor, cs: int) -> torch.Tensor:
    """R (4, H, DH, DH) as the ranks' slabs (H, CS, DH, 4U), U = DH / CS:
    slab[h, k, d, g U + u] = R[g, h, d, k U + u], each (h, k) contiguous."""
    four, h, dh, _ = r.shape
    u = dh // cs
    return r.reshape(four, h, dh, cs, u).permute(1, 3, 2, 0, 4).reshape(h, cs, dh, four * u).contiguous()


def scan_partitioned(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, cs: int
                     ) -> Tuple[torch.Tensor, SState]:
    """The kernel's partition in plain PyTorch: at each step every rank
    computes its units' four gates from its slab alone, as CS K slices of U
    rows added in slice order, updates their cells, and the ranks' h slices
    are gathered into the next step's h. Same contract as slstm_sequential."""
    bsz, t, _, heads, dh = wx.shape
    u = dh // cs
    slabs = pack_r_slabs(r.float(), cs)  # (H, CS, DH, 4U)
    bias = b.float().reshape(4, heads, cs, u)
    hp, cp, np_, mp = (s.reshape(bsz, heads, cs, u) for s in slstm_init_state(bsz, heads, dh, wx.device))
    hs = []
    for i in range(t):
        pre_w = wx[:, i].float().reshape(bsz, 4, heads, cs, u)
        h_new, c_new, n_new, m_new = [], [], [], []
        for k in range(cs):
            rec = torch.zeros(bsz, heads, 4 * u, dtype=torch.float32, device=wx.device)
            hprev = hp.reshape(bsz, heads, dh)
            for s in range(cs):  # K slices in order
                rec = rec + torch.einsum("bhd,hdc->bhc", hprev[:, :, s * u:(s + 1) * u],
                                         slabs[:, k, s * u:(s + 1) * u])
            pre = (pre_w[:, :, :, k] + rec.reshape(bsz, heads, 4, u).transpose(1, 2)) + bias[None, :, :, k]
            ig, fg, zg, og = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
            m_prev = mp[:, :, k]
            m_k = torch.maximum(fg + m_prev, ig)
            i_act = torch.exp(ig - m_k)
            f_act = torch.where(torch.isinf(m_prev), torch.zeros_like(fg), torch.exp(fg + m_prev - m_k))
            c_k = f_act * cp[:, :, k] + i_act * torch.tanh(zg)
            n_k = f_act * np_[:, :, k] + i_act
            h_new.append(torch.sigmoid(og) * c_k / n_k)
            c_new.append(c_k)
            n_new.append(n_k)
            m_new.append(m_k)
        hp, cp, np_, mp = (torch.stack(x, dim=2) for x in (h_new, c_new, n_new, m_new))
        hs.append(hp.reshape(bsz, heads, dh))
    final = tuple(s.reshape(bsz, heads, dh) for s in (hp, cp, np_, mp))
    return torch.stack(hs, dim=1), final


def max_active_clusters(geo: Geometry, bsz: int, t: int, heads: int, dh: int) -> int:
    """cudaOccupancyMaxActiveClusters of the launch (on the card)."""
    lib = load_library()
    out = ctypes.c_int(0)
    err = lib.mg_slstm_scan_clusters(bsz, t, heads, dh, geo.cs, geo.rows, geo.smem, ctypes.addressof(out))
    check(lib, err, "slstm_scan (cudaOccupancyMaxActiveClusters)")
    return out.value


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, cs: Optional[int] = None,
               stamps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SState]:
    """sLSTM over the whole sequence from the zero state.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    has no backward: under grad mode it refuses inputs that require grad
    (the model trains through the plain scan, as the JAX package does).
    `cs` is the cluster size (scan_geometry's by default); `stamps`, an int64
    CUDA tensor of 4 + 3 n entries, receives the first cluster's timer
    stamps of its first n steps (csrc/slstm_scan.cu mg_slstm_scan)."""
    if not wx.is_cuda:
        return slstm_sequential(wx, r, b)
    refuse_grad("slstm_scan (kernel H)", wx, r, b)
    geo = launch_geometry(wx, r, b, cs)
    for a in (wx, r, b):
        if a.device != wx.device or a.dtype != torch.float32:
            raise ValueError("slstm_scan: all inputs must be float32 on one CUDA device")
    bsz, t, _, h, dh = wx.shape
    wx, b = wx.contiguous(), b.contiguous()
    slabs = pack_r_slabs(r, geo.cs)
    h_out = torch.empty(bsz, t, h, dh, dtype=torch.float32, device=wx.device)
    state = torch.empty(4, bsz, h, dh, dtype=torch.float32, device=wx.device)
    n_stamps = 0
    if stamps is not None:
        if not stamps.is_cuda or stamps.dtype != torch.int64 or stamps.numel() < 4:
            raise ValueError("slstm_scan: stamps must be an int64 CUDA tensor of 4 + 3 n entries")
        n_stamps = (stamps.numel() - 4) // 3
    lib = load_library()
    err = lib.mg_slstm_scan(wx.data_ptr(), slabs.data_ptr(), b.data_ptr(), h_out.data_ptr(), state.data_ptr(),
                            bsz, t, h, dh, geo.cs, geo.rows, geo.smem,
                            None if stamps is None else stamps.data_ptr(), n_stamps, stream_ptr(wx))
    check(lib, err, "slstm_scan")
    slstm_scan.launches += 1
    return h_out, (state[0], state[1], state[2], state[3])


slstm_scan.launches = 0
