"""The fallback colours' draw (``native/mt_draw.cpp`` through
``native/mt_draw_native.draw_u8``) on the CPU: bit for bit the values of
``torch.randint(256, (T, 3))``, the generator's state after it and the
draw that follows; the ``torch.randint`` path where the state is another
size; the counters a frame; the pinned buffer's rule for reuse; and the
expansion to (T, 3, 3) float32 colours on the CPU."""
import shutil

import pytest
import torch

import cython3dmodelrenderer_tpu_torch as pt
from cython3dmodelrenderer_tpu_torch import renderer as renderer_mod
from cython3dmodelrenderer_tpu_torch.native import mt_draw_native
from cython3dmodelrenderer_tpu_torch.ops.colors import vertex_colors
from cython3dmodelrenderer_tpu_torch.utils.timing import counters
from test_torch_fallback_span import renderer  # noqa: F401 (and fixtures)
from test_torch_fallback_span import cube, textured  # noqa: F401

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native draw builds with g++")


def generator(seed, drawn):
    g = torch.Generator().manual_seed(seed)
    if drawn:
        torch.randint(256, (drawn,), generator=g)
    return g


def assert_draw_is_randint(t, seed, drawn):
    native, plain = generator(seed, drawn), generator(seed, drawn)
    got = torch.full((t, 3), 77, dtype=torch.uint8)
    assert mt_draw_native.draw_u8(native, got)
    want = torch.randint(256, (t, 3), generator=plain)
    assert torch.equal(got.long(), want)
    assert torch.equal(native.get_state(), plain.get_state())
    assert torch.equal(torch.randint(256, (9, 3), generator=native),
                       torch.randint(256, (9, 3), generator=plain))


@needs_gxx
@pytest.mark.parametrize("drawn", [0, 7])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 62 + 7])
@pytest.mark.parametrize("t", [0, 1, 207, 208, 209, 6016])
def test_native_draw_is_randint(t, seed, drawn):
    """Sizes on both sides of one block of 624 outputs (208 triangles),
    from a fresh generator and from one 7 values into its block."""
    assert_draw_is_randint(t, seed, drawn)


@needs_gxx
def test_native_draw_is_randint_at_the_dragon():
    """3 x 871,824 draws: 4,192 blocks of the engine."""
    assert_draw_is_randint(871_824, 2 ** 62 + 7, 7)


@needs_gxx
def test_native_draw_refuses_a_state_it_cannot_read():
    """Bytes of the right size that no engine accepts (``left`` 0) give
    -1 and leave the output and the bytes as they were."""
    lib = mt_draw_native._load()
    state = torch.Generator().manual_seed(3).get_state()
    state[8:12] = 0                                     # left
    before = state.clone()
    out = torch.full((4,), 9, dtype=torch.uint8)
    assert lib.mt_draw_u8(state.data_ptr(), state.numel(), out.data_ptr(),
                          out.numel()) == -1
    assert torch.equal(state, before) and torch.equal(out, torch.full_like(out, 9))
    assert lib.mt_draw_u8(state.data_ptr(), state.numel() - 8,
                          out.data_ptr(), out.numel()) == -1


@pytest.mark.parametrize("out", [torch.empty((4, 3), dtype=torch.int64),
                                 torch.empty((3, 4), dtype=torch.uint8).t()])
def test_native_draw_refuses_an_output_it_cannot_write(out):
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    with pytest.raises(ValueError, match="contiguous uint8"):
        mt_draw_native.draw_u8(g, out)
    assert torch.equal(g.get_state(), before)


class PaddedState(torch.Generator):
    """A generator whose state reads 8 bytes longer than torch's."""

    def get_state(self):
        return torch.cat([super().get_state(),
                          torch.zeros(8, dtype=torch.uint8)])


def test_another_state_size_takes_randint(cube):                 # noqa: F811
    """A state of another size: ``draw_u8`` declines and leaves the
    generator; the colours come from ``torch.randint``, equal, and count
    ``fallback_draws_torch``."""
    padded = PaddedState().manual_seed(5)
    assert not mt_draw_native.draw_u8(padded, torch.empty(3, dtype=torch.uint8))
    r = renderer()
    r.generator = padded
    before = counters.copy()
    got = r._fallback_colors(cube, True)
    t = cube.n_triangles()
    want = torch.randint(256, (t, 3), generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want.float()[:, None, :].expand(t, 3, 3))
    assert counters["fallback_draws_torch"] == before["fallback_draws_torch"] + 1
    assert counters["fallback_draws_native"] == before["fallback_draws_native"]


def test_without_a_compiler_randint_draws(monkeypatch, cube):     # noqa: F811
    monkeypatch.setattr(mt_draw_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(mt_draw_native, "_lib", None)
    before = counters["fallback_draws_torch"]
    got = renderer()._fallback_colors(cube, True)
    t = cube.n_triangles()
    want = torch.randint(256, (t, 3), generator=torch.Generator().manual_seed(11))
    assert torch.equal(got, want.float()[:, None, :].expand(t, 3, 3))
    assert counters["fallback_draws_torch"] == before + 1


@needs_gxx
def test_a_frame_counts_its_draw(cube, textured):                # noqa: F811
    """An untextured frame draws once, natively; a textured frame and a
    white one draw nothing."""
    r = renderer()
    keys = ("fallback_draws_native", "fallback_draws_torch")
    before = [counters[k] for k in keys]
    r.render(cube)
    assert [counters[k] for k in keys] == [before[0] + 1, before[1]]
    r.render(textured)
    r.render(cube, random_colors=False)
    assert [counters[k] for k in keys] == [before[0] + 1, before[1]]


class FakeEvent:
    def __init__(self):
        self.busy, self.waited = False, 0

    def query(self):
        return not self.busy

    def synchronize(self):
        self.waited += 1
        self.busy = False

    def record(self, _stream):
        self.busy = True


@pytest.mark.parametrize("busy,waits", [
    (False, 0),                 # the last launch ran: draw at once
    (True, 1),                  # still queued: wait for it, then draw
])
def test_pinned_buffers_rewrite_only_after_their_launch(monkeypatch, busy,
                                                        waits):
    """``_PinnedColors.send`` draws into its buffer only once the last
    launch that read it has run, waiting for it otherwise, and records the
    event after the new launch; on the CPU the expansion is
    ``vertex_colors_plain``."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    staging = renderer_mod._PinnedColors.__new__(renderer_mod._PinnedColors)
    staging.t = 2
    staging.buffer = torch.zeros((2, 3), dtype=torch.uint8)
    staging.event = FakeEvent()
    staging.event.busy = busy
    drawn = []

    def draw(host):
        assert not staging.event.busy
        drawn.append(host.fill_(5))

    sent = staging.send(draw, torch.device("cpu"))
    assert len(drawn) == 1 and drawn[0] is staging.buffer
    assert torch.equal(sent, torch.full((2, 3, 3), 5.0))
    assert staging.event.waited == waits and staging.event.busy


@pytest.mark.parametrize("t", [0, 1, 255, 256, 257])
def test_vertex_colors_plain_repeats_each_colour(t):
    """``ops/colors.py``: each triangle's bytes, as float32, for each of its
    three vertices; the CPU device takes the plain version."""
    per_tri = torch.randint(256, (t, 3), generator=torch.Generator()
                            .manual_seed(t)).to(torch.uint8)
    got = vertex_colors(per_tri, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, per_tri.float()[:, None, :].expand(t, 3, 3))
