"""Per-replica cost of the raster epilogue's primitives — kernel P1 and its
plain version.

``run`` replaces the TPU kernel of ``tools/probes/epi_prims.py``
(``make_kernel``, launched by ``prim_ms.run``, ``epi_prims.py:275``; the
primitives are its ``_prim_body``): for a (16, 32, 128) f32 tile ``x`` and
one primitive, the (1, 1) f32 sum over ``reps`` replicas, in rep order, of
``prim(x + rep * 1e-30)``. Each replica computes the primitive's whole
tensor and returns one element of it or its sum. The scratch tensors are
``attr = x`` and, for the group primitives, ``attr6[c] = x + c``.
``pltpu.roll`` is ``torch.roll``: lane k reads lane k - shift.

On a CUDA tensor ``run`` launches ``csrc/epi_prims.cu``: 64 row blocks
(8 (h, w) rows, a warp each) by up to 32 replica chunks, each block
running its chunk's replicas in order (see the source); on a CPU tensor it
runs ``run_plain``.

On the card (fails without one)::

    python -m cython3dmodelrenderer_tpu_torch.probes.epi_prims [prim...]

prints, for each primitive (default ``PRIMS``), µs per replica from the
slope of ms per call over ``REPS`` replicas, and the ms per call (CUDA
events), as the JAX probe prints them. The TPU ran the replicas in
sequence on one core; here the slope is the whole card's time per
replica with every SM busy (before the grid spread the replicas, it was
one replica of one TH row on one SM).
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import cuda_build
from ..device import resolve_backend, resolve_device
from ..measure import cuda_time_ms, smi
from ..utils import timing

TH, TW, K = 16, 32, 128
SUB = 16
REPS = (0, 128, 256)
PRIMS = ("reduce", "wherered", "extract", "roll", "segsum", "segsum6",
         "stack6red", "epi_cur", "epi_bfly_once", "epi_bfly_stripe",
         "slicered", "epi_slice", "epi_cur6")
GROUP_PRIMS = ("epi_cur8", "epi_rr_group")        # need attr6
#: every primitive, in the kernel's order (csrc/epi_prims.cu ``Prim``)
ALL_PRIMS = PRIMS + GROUP_PRIMS
#: primitives whose scalar is one element of their tensor: exact in any
#: order of evaluation
ELEMENT_PRIMS = ("reduce", "wherered", "extract", "roll", "stack6red")
#: f32 operations of one epi_cur6 replica per (h, w) row, counted over the
#: 16 lanes of segment 3, the only ones that can contribute: per lane the
#: perturbing add, 6 attribute adds, the segment min, the candidate
#: compare, the lane select and min, the winner compare and and, 6 selects
#: and 6 maxes (25); per row the empty-segment compare, the z select, 6
#: attribute selects and 7 adds of the row's 8 outputs (15)
EPI_CUR6_OPS_PER_ROW = SUB * 25 + 15
_INF = float("inf")


def make_input(device=None):
    """The probe's ``x`` (``default_rng(0).random((16, 32, 128))`` as f32)
    and the 0/1 (128, 128) segment matrix, on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    x = np.random.default_rng(0).random((TH, TW, K)).astype(np.float32)
    seg = np.arange(K) // SUB
    smat = (seg[:, None] == seg[None, :]).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(smat).to(dev)


def _lanes(device):
    lane = torch.arange(K, device=device).view(1, 1, K)
    return lane, lane // SUB, lane.to(torch.float32)


def _roll(v: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(v, shift, dims=-1)


def _segsum(v: torch.Tensor, smat: torch.Tensor) -> torch.Tensor:
    """``v @ smat`` one k at a time in order, as the kernel sums it."""
    y = torch.zeros(v.shape[0], K, dtype=torch.float32, device=v.device)
    for k in range(K):
        y = y + v[:, k:k + 1] * smat[k]
    return y


def _epilogue(x, inseg, lanef, afin):
    """The per-stripe epilogue: [av0, av1, av2, zt_out, av3, av4, av5, 0]
    over the (TH, 8 TW) block, summed."""
    zt = torch.amin(torch.where(inseg, x, _INF), dim=2)
    zt_out = torch.where(torch.isinf(zt), 0.0, zt)
    cand = inseg & (x == zt[..., None])
    lmin = torch.amin(torch.where(cand, lanef, _INF), dim=2)
    win = cand & (lanef == lmin[..., None])
    has = ~torch.isinf(zt)
    av = torch.amax(torch.where(win[None], afin, -_INF), dim=3)
    av = torch.where(has[None], av, 0.0)
    return _block_sum(av, zt_out)


def _block_sum(av, zt_out):
    out = torch.cat([av[0], av[1], av[2], zt_out, av[3], av[4], av[5],
                     torch.zeros_like(zt_out)], dim=1)
    return out.sum()


def prim_plain(name: str, x, attr, smat, attr6=None) -> torch.Tensor:
    """One replica of primitive ``name`` on the perturbed tile ``x``: the
    0-dim f32 value ``_prim_body`` folds into the carry."""
    lane, seg, lanef = _lanes(x.device)
    x000 = x[0, 0, 0]
    if name == "reduce":
        return torch.amin(x, dim=2)[0, 0]
    if name == "wherered":
        return torch.amin(torch.where(seg == 3, x, _INF), dim=2)[0, 0]
    if name == "extract":
        return x[:, :, 48][0, 0]
    if name == "roll":
        return _roll(x, 16)[0, 0, 0]
    if name == "segsum":
        return _segsum(x.reshape(TH * TW, K), smat)[0, 0]
    if name == "segsum6":
        v = x[None].expand(6, TH, TW, K).reshape(6 * TH * TW, K)
        return _segsum(v, smat)[0, 0]
    if name == "stack6red":
        st = (attr[None] + x000).expand(6, TH, TW, K)
        return torch.amax(torch.where((seg == 3)[None], st, -_INF), dim=3)[0, 0, 0]
    if name == "epi_cur":
        afin = (attr[None] + x000).expand(6, TH, TW, K)
        return _epilogue(x, seg == 3, lanef, afin)
    if name == "epi_cur6":
        a6 = torch.stack([attr + float(c) for c in range(6)])
        return _epilogue(x, seg == 3, lanef, a6)
    if name == "epi_cur8":
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(8):
            total = total + _epilogue(x, seg == s, lanef, attr6 + x000)
        return total
    if name == "epi_bfly_once":
        lmod = lane % SUB

        def segmin(v):
            for sh in (1, 2, 4, 8):
                fwd, bwd = _roll(v, sh), _roll(v, K - sh)
                v = torch.minimum(v, torch.where(lmod >= sh, fwd, _INF))
                v = torch.minimum(v, torch.where(lmod < SUB - sh, bwd, _INF))
            return v

        ztb = segmin(x)
        cand = x == ztb
        lmb = segmin(torch.where(cand, lanef, _INF))
        win = cand & (lanef == lmb)
        return torch.where(win, x, 0.0).sum() + ztb.sum()
    if name == "epi_bfly_stripe":
        win = x > 0.5                    # stand-in mask, as in the probe
        afin = (attr[None] + x000).expand(6, TH, TW, K)
        inseg = seg == 3
        zt = torch.amin(torch.where(inseg, x, _INF), dim=2)
        zt_out = torch.where(torch.isinf(zt), 0.0, zt)
        has = ~torch.isinf(zt)
        av = torch.amax(torch.where((win & inseg)[None], afin, -_INF), dim=3)
        return _block_sum(torch.where(has[None], av, 0.0), zt_out)
    if name == "slicered":
        return torch.amin(x[:, :, 3 * SUB:4 * SUB], dim=2).sum()
    if name == "epi_slice":
        lf = lanef[:, :, 3 * SUB:4 * SUB]
        xs = x[:, :, 3 * SUB:4 * SUB]
        a6 = torch.stack([attr[:, :, ((3 + c) % 8) * SUB:((3 + c) % 8 + 1) * SUB]
                          + xs for c in range(6)])
        zt = torch.amin(xs, dim=2)
        zt_out = torch.where(torch.isinf(zt), 0.0, zt)
        cand = xs == zt[..., None]
        lmin = torch.amin(torch.where(cand, lf, _INF), dim=2)
        win = cand & (lf == lmin[..., None])
        has = ~torch.isinf(zt)
        av = torch.amax(torch.where(win[None], a6, -_INF), dim=3)
        return _block_sum(torch.where(has[None], av, 0.0), zt_out)
    if name == "epi_rr_group":
        def segred(v, op):
            for sh in (8, 16, 32, 64):
                v = op(v, _roll(v, sh))
            return v

        ztb = segred(x, torch.minimum)
        cand = x == ztb
        lmb = segred(torch.where(cand, lanef, _INF), torch.minimum)
        win = cand & (lanef == lmb)
        has = ~torch.isinf(ztb)
        a6 = attr6 + x000
        planes = [torch.where(has, segred(torch.where(win, a6[c], 0.0),
                                          torch.add), 0.0) for c in range(6)]
        zt_out = torch.where(has, ztb, 0.0)
        order = planes[:3] + [zt_out] + planes[3:] + [torch.zeros_like(zt_out)]
        gout = torch.zeros_like(x)
        for p in range(8):
            gout = torch.where(lane // 8 == p, order[p], gout)
        return gout.sum()
    raise ValueError(f"unknown primitive {name!r}")


def _perturbation(rep: int) -> float:
    """``rep * 1e-30`` rounded as f32 arithmetic rounds it."""
    return float(np.float32(rep) * np.float32(1e-30))


def _check(name: str, reps: int, x: torch.Tensor, smat: torch.Tensor) -> None:
    if name not in ALL_PRIMS:
        raise ValueError(f"unknown primitive {name!r}; one of {ALL_PRIMS}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    for t, shape in ((x, (TH, TW, K)), (smat, (K, K))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"epi_prims takes contiguous float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if x.device != smat.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"epi_prims: unsupported devices {x.device}, "
                         f"{smat.device}")


def run_plain(name: str, reps: int, x: torch.Tensor,
              smat: torch.Tensor) -> torch.Tensor:
    """The plain version: (1, 1) f32, the replicas' values summed in rep
    order from 0."""
    _check(name, reps, x, smat)
    attr6 = (torch.stack([x + float(c) for c in range(6)])
             if name in GROUP_PRIMS else None)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for rep in range(reps):
        acc = acc + prim_plain(name, x + _perturbation(rep), x, smat, attr6)
    return acc.reshape(1, 1)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("epi_prims")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.epi_prims_launch.argtypes = [i, p, p, i, p, p, i, i, p]
    lib.epi_prims_launch.restype = ctypes.c_int
    lib.epi_prims_smem_bytes.argtypes = [i]
    lib.epi_prims_smem_bytes.restype = ctypes.c_int
    return lib


def _launch(name: str, reps: int, x: torch.Tensor, smat: torch.Tensor,
            smem_bytes=None) -> torch.Tensor:
    """Launch kernel P1 and its combine; ``smem_bytes`` (default: the
    primitive's need) is the dynamic shared memory asked for."""
    lib = _lib()
    prim = ALL_PRIMS.index(name)
    if smem_bytes is None:
        smem_bytes = lib.epi_prims_smem_bytes(prim)
    partials = torch.empty((max(reps, 1), TH, TW), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    err = lib.epi_prims_launch(prim, x.data_ptr(), smat.data_ptr(), reps,
                               partials.data_ptr(), out.data_ptr(),
                               smem_bytes, x.device.index,
                               cuda_build.stream_handle(x.device))
    cuda_build.check(lib, err, f"epi_prims {name} (csrc/epi_prims.cu)")
    return out


def run(name: str, reps: int, x: torch.Tensor, smat: torch.Tensor,
        backend: str = "auto") -> torch.Tensor:
    """Primitive ``name`` over ``reps`` replicas → (1, 1) f32.

    ``backend="auto"`` launches kernel P1 on CUDA tensors and runs
    ``run_plain`` on CPU tensors; ``"cuda"`` raises for CPU tensors;
    ``"torch"`` runs the plain version anywhere.
    """
    _check(name, reps, x, smat)
    if resolve_backend(backend, x.device) == "torch":
        return run_plain(name, reps, x, smat)
    out = _launch(name, reps, x, smat)
    if reps > 0:        # at 0 replicas only the combine runs
        timing.counters["launch.epi_prims"] += 1
    return out


def measure(name: str, x: torch.Tensor, smat: torch.Tensor, n: int = 10):
    """(µs per replica from the slope over ``REPS``, ms per call at each)."""
    walls = [cuda_time_ms(lambda: run(name, r, x, smat), n) for r in REPS]
    slope = np.polyfit(np.asarray(REPS, np.float64), np.asarray(walls), 1)[0]
    return slope * 1e3, walls


def report(name: str, per_us: float, walls) -> None:
    print(f"{name:10s}: {per_us:8.3f} us/op   walls "
          + " ".join(f"{w:6.3f}" for w in walls), flush=True)


def main(argv) -> int:
    want = [a for a in argv if not a.isdigit()] or list(PRIMS)
    x, smat = make_input()                # the card; raises without one
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi name, power.limit: "
          + smi("name,power.limit"), flush=True)
    for name in want:
        report(name, *measure(name, x, smat))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
