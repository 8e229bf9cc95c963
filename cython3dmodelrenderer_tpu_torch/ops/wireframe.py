"""Wireframe rendering: closed-form Bresenham line rasterization.

Counterpart of ``cython3dmodelrenderer_tpu/ops/wireframe.py``. The reference
draws triangle edges with integer Bresenham stepping over per-pixel
``Buffer.set_pixel`` calls
(``crender/py/pixel_buffer_filler/edge_only/line_drawer/bresenham/line_bresenham.py:6-45``).
Bresenham has a closed form: after ``t`` steps the major axis has advanced
``t`` and the minor axis ``m(t) = floor((2·es·t + el - 1) / (2·el))``
(``el = max(|dx|, |dy|)``, ``es = min(|dx|, |dy|)``), so every pixel of
every line is computed independently. Each line is first clipped to the
viewport (phase-preserving: the step counter still runs from the line's
first endpoint), so far off-screen endpoints draw their visible segment
exactly. Later lines win crossings, through a per-pixel priority
scatter-max (``scatter_reduce("amax")``, order-free on every device).

The step and clip arithmetic runs in int64, where every division is exact;
the JAX package's int32 ``_floordiv_exact`` (a float estimate corrected by
a wrapped residual) has no counterpart, and both agree wherever that one is
exact (endpoints within ~±2²⁴ of the viewport). Lines are stepped only as
far as the longest visible run needs (``max_steps`` bounds it), and
``LINE_ELEMS`` (line, step) pairs a pass, so the working set stays bounded
at any width; the priority maximum makes the passes order-free.

``LineDrawer`` / ``LineBresenham`` keep the reference's scalar per-line API
(``line_drawer.py:4``).
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Tuple

import torch

#: (line, step) pairs stepped per pass of ``rasterize_lines``
LINE_ELEMS = 1 << 23


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 toward zero as XLA converts: saturating, NaN → 0."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _line_params(p1: torch.Tensor, p2: torch.Tensor):
    """Per-line Bresenham constants. p1/p2: (..., 2) integers."""
    d = p2 - p1
    sign = torch.sign(d)
    ad = torch.abs(d)
    major_is_x = ad[..., 0] > ad[..., 1]
    el = torch.where(major_is_x, ad[..., 0], ad[..., 1])
    es = torch.where(major_is_x, ad[..., 1], ad[..., 0])
    return sign, el, es, major_is_x


def _first_step(p1, sign, el, es, major_is_x, height: int, width: int):
    """The first step ``t0`` whose pixel can be on-screen (``el`` when
    none is): the major axis advances 1 a step and the minor axis never
    goes back, so the visible steps are one window of at most
    ``max(h, w)`` steps from ``t0``."""
    maj1 = torch.where(major_is_x, p1[:, 0], p1[:, 1])
    min1 = torch.where(major_is_x, p1[:, 1], p1[:, 0])
    smaj = torch.where(major_is_x, sign[:, 0], sign[:, 1])
    smin = torch.where(major_is_x, sign[:, 1], sign[:, 0])
    mmaj = torch.where(major_is_x, width, height)
    mmin = torch.where(major_is_x, height, width)
    zero = torch.zeros_like(maj1)
    t_maj = torch.where(smaj > 0, -maj1,
                        torch.where(smaj < 0, maj1 - (mmaj - 1), zero)).clamp(min=0)
    # the minor axis must advance by at least k before it enters the view
    k = torch.where(smin > 0, -min1,
                    torch.where(smin < 0, min1 - (mmin - 1), zero)).clamp(min=0)
    # smallest t with m(t) >= k  <=>  t >= ceil((2·el·k - el + 1) / (2·es))
    es_safe = es.clamp(min=1)
    t_min = torch.div(2 * el * k - el + 1 + (2 * es - 1), 2 * es_safe,
                      rounding_mode="floor")
    # es == 0 with k > 0: the minor axis never advances → nothing visible
    t_min = torch.where(k > 0, torch.where(es > 0, t_min, el + 1), zero)
    return torch.minimum(torch.maximum(t_maj, t_min).clamp(min=0), el)


def rasterize_lines(color: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                    line_colors: torch.Tensor, active: torch.Tensor,
                    height: int, width: int, max_steps: int) -> torch.Tensor:
    """Draw L lines into a colour image; returns the new image.

    ``color`` (H, W, C); ``p1``, ``p2`` (L, 2) integer endpoints (x, y);
    ``line_colors`` (L, C); ``active`` (L,) bool; ``max_steps`` bounds the
    ON-SCREEN pixels of a line and must be ≥ max(height, width) + 1. The
    highest-index line covering a pixel wins, as the reference's
    sequential draw order does. Every tensor on the image's device.
    """
    n_lines = p1.shape[0]
    hw = height * width
    c = color.shape[-1]
    flat = color.reshape(hw, c)
    if n_lines == 0:
        return flat.clone().reshape(color.shape)
    dev = color.device
    p1, p2 = p1.to(torch.int64), p2.to(torch.int64)
    sign, el, es, major_is_x = _line_params(p1, p2)
    el_safe = el.clamp(min=1)
    t0 = _first_step(p1, sign, el, es, major_is_x, height, width)

    # steps past every line's end draw nothing: step only as far as the
    # longest visible run needs (one host read)
    n_steps = min(max_steps, int((el - t0).max()) + 1)
    steps = torch.arange(n_steps, device=dev)
    win = torch.full((hw,), -1, dtype=torch.int64, device=dev)
    per_pass = max(1, LINE_ELEMS // n_steps)
    for a in range(0, n_lines, per_pass):
        s = slice(a, min(n_lines, a + per_pass))
        t = t0[s, None] + steps[None, :]
        # minor-axis advance after t steps (closed-form Bresenham)
        m = torch.div(2 * es[s, None] * t + (el[s, None] - 1),
                      2 * el_safe[s, None], rounding_mode="floor")
        m = torch.where(t == 0, 0, m)
        mx = major_is_x[s, None]
        px = p1[s, 0:1] + torch.where(mx, t, m) * sign[s, 0:1]
        py = p1[s, 1:2] + torch.where(mx, m, t) * sign[s, 1:2]
        good = ((t <= el[s, None]) & (px >= 0) & (px < width) & (py >= 0)
                & (py < height) & active[s, None])
        # an undrawn step scatters the no-op -1 at a pixel of its own
        # (its (line, step) slot wrapped into the image), so the card's
        # atomics do not queue on one dump slot
        slot = (s.start * n_steps
                + torch.arange(t.numel(), device=dev).reshape(t.shape)) % hw
        idx = torch.where(good, py * width + px, slot).reshape(-1)
        prio = torch.arange(s.start, s.stop, device=dev)[:, None]
        win.scatter_reduce_(0, idx, torch.where(good, prio, -1).reshape(-1),
                            "amax")
    has = win >= 0
    win_c = line_colors[win.clamp(0, n_lines - 1)].to(flat.dtype)
    return torch.where(has[:, None], win_c, flat).reshape(color.shape)


def triangle_edges(tri_xy_int: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Expand (T, 3, 2) integer vertices into (3T, 2) edge endpoint pairs,
    p0→p1, p1→p2, p2→p0 per triangle (``edge_only_pixel_buffer_filler.py:
    21-28``)."""
    p0, p1, p2 = tri_xy_int[:, 0], tri_xy_int[:, 1], tri_xy_int[:, 2]
    starts = torch.stack([p0, p1, p2], dim=1).reshape(-1, 2)
    ends = torch.stack([p1, p2, p0], dim=1).reshape(-1, 2)
    return starts, ends


# --------------------------------------------------------------------------
# Reference-compatible scalar API
# --------------------------------------------------------------------------


class LineDrawer:
    @abstractmethod
    def draw_line(self, p1, p2, image, color):
        ...


class LineBresenham(LineDrawer):
    """Scalar integer line walk over ``Buffer.set_pixel``.

    The single-line compat path; the batched wireframe uses
    ``rasterize_lines``. A doubled-error accumulator seeded at ``major``
    keeps every comparison exact in integers, and the emitted pixels equal
    the closed form's. Ties (``dx == dy``) walk y-major.
    """

    def draw_line(self, p1, p2, image, color):
        x, y = int(p1[0]), int(p1[1])
        xe, ye = int(p2[0]), int(p2[1])
        step_x = 1 if xe > x else (-1 if xe < x else 0)
        step_y = 1 if ye > y else (-1 if ye < y else 0)
        dx, dy = abs(xe - x), abs(ye - y)
        x_major = dx > dy
        major, minor = (dx, dy) if x_major else (dy, dx)
        err2 = major                      # 2 × the half-pixel threshold
        image.set_pixel(x, y, color)
        for _ in range(major):
            err2 -= 2 * minor
            if err2 < 0:                  # minor axis crossed a pixel centre
                err2 += 2 * major
                x += step_x
                y += step_y
            elif x_major:
                x += step_x
            else:
                y += step_y
            image.set_pixel(x, y, color)
