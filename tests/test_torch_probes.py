"""The calibration probes' plain versions against the JAX probes.

P1 (``probes/epi_prims.py``): ``tools/probes/epi_prims.py`` runs its probe
when imported, so its definitions are read with ``ast`` up to the
``PRIMS =`` assignment and executed; the ``pallas_call`` is built as
``prim_ms.run`` builds it and runs on the CPU under
``force_tpu_interpret_mode``, for every primitive at 0 and 2 replicas.
Tolerances: the primitives whose scalar is one element (``reduce``,
``wherered``, ``extract``, ``roll``, ``stack6red``) are exact in any order
and must be bit-equal. The rest sum 16 to 2 x 65,536 floats, in XLA's
order on one side and torch's on the other: ``rtol=2e-6``, and 1e-5 for
``epi_bfly_once``, whose two 65,536-term sums XLA:CPU takes 4.2e-6 off
their float64 value here (torch's within 1e-7).

P2 (``probes/vpu_cal.py``): the JAX probe's ``make(n)(x)`` at ``GRID`` = 4
(read when the kernel is traced), in a subprocess (this file as a script)
with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, without which XLA contracts
``acc * x + j`` into an FMA; the scalar after ``NITER`` chained runs must
be bit-equal. The plain run is also held bit for bit against a NumPy
float32 statement of the loop.
"""
import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cython3dmodelrenderer_tpu_torch.probes import epi_prims, vpu_cal
from cython3dmodelrenderer_tpu_torch.utils.timing import counters
from test_torch_raster import REPO, run_jax_reference

P2_GRID = 4
P2_N_OPS = (8, 32)
RTOL = dict({name: 0.0 for name in epi_prims.ELEMENT_PRIMS},
            epi_bfly_once=1e-5)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# P1: epi_prims
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_epi_prims():
    """The JAX probe's definitions (``_prim_body``, ``make_kernel``, ...)
    without its module-level run."""
    path = os.path.join(REPO, "tools", "probes", "epi_prims.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    stop = next(i for i, node in enumerate(tree.body)
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "PRIMS" for t in node.targets))
    ns = {"__name__": "epi_prims_definitions"}
    exec(compile(ast.Module(body=tree.body[:stop], type_ignores=[]), path,
                 "exec"), ns)
    return ns


def jax_prim_run(ns, name, reps):
    """``prim_ms.run`` of the JAX probe (``epi_prims.py:274-283``), once,
    in interpret mode: the (1, 1) output."""
    th, tw, k = ns["TH"], ns["TW"], ns["K"]
    x = jnp.asarray(np.random.default_rng(0).random((th, tw, k)), jnp.float32)
    smat = jnp.asarray(ns["SMAT"])
    kernel = ns["make_kernel"](name, reps)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((th, tw, k), jnp.float32),
                            pltpu.VMEM((6, th, tw, k), jnp.float32)],
        )(x, smat)
        return np.asarray(out)


@pytest.mark.parametrize("reps", [0, 2])
@pytest.mark.parametrize("name", epi_prims.ALL_PRIMS)
def test_epi_prims_plain_matches_jax(jax_epi_prims, name, reps):
    want = jax_prim_run(jax_epi_prims, name, reps)
    x, smat = epi_prims.make_input("cpu")
    got = epi_prims.run(name, reps, x, smat)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert np.isfinite(want).all()
    rtol = RTOL.get(name, 2e-6)
    if rtol == 0.0 or reps == 0:
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("name", epi_prims.ALL_PRIMS)
def test_epi_prims_plain_replicas_fold_in_order(name):
    """Every replica sees the same tile (x + rep * 1e-30 rounds to x), so R
    replicas are R f32 adds of the one-replica value, in rep order: what
    lets the card check hold the kernel to the plain version at any R."""
    x, smat = epi_prims.make_input("cpu")
    one = np.float32(epi_prims.run_plain(name, 1, x, smat).item())
    fold = np.float32(0.0)
    for _ in range(3):
        fold = np.float32(fold + one)
    got = epi_prims.run_plain(name, 3, x, smat).numpy()
    np.testing.assert_array_equal(bits(got), bits(np.full((1, 1), fold)))


def test_epi_prims_wrapper_runs_plain_on_cpu_and_refuses_the_rest():
    x, smat = epi_prims.make_input("cpu")
    before = counters["launch.epi_prims"]
    assert torch.equal(epi_prims.run("epi_cur6", 2, x, smat),
                       epi_prims.run_plain("epi_cur6", 2, x, smat))
    assert torch.equal(epi_prims.run("roll", 1, x, smat, backend="torch"),
                       epi_prims.run_plain("roll", 1, x, smat))
    assert counters["launch.epi_prims"] == before
    with pytest.raises(ValueError, match="CUDA device"):
        epi_prims.run("reduce", 2, x, smat, backend="cuda")
    with pytest.raises(ValueError, match="unknown primitive"):
        epi_prims.run("transpose", 2, x, smat)
    with pytest.raises(ValueError, match="reps"):
        epi_prims.run("reduce", -1, x, smat)
    with pytest.raises(ValueError, match="float32"):
        epi_prims.run("reduce", 2, x.double(), smat)
    with pytest.raises(ValueError, match="unsupported"):
        epi_prims.run("reduce", 2, x.to("meta"), smat.to("meta"))


# ---------------------------------------------------------------------------
# P2: vpu_cal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vpu_cal(tmp_path_factory):
    return run_jax_reference(os.path.abspath(__file__),
                             {"n_ops": np.asarray(P2_N_OPS)},
                             tmp_path_factory.mktemp("jax_vpu_cal"))


@pytest.mark.parametrize("n_ops", P2_N_OPS)
def test_vpu_cal_plain_matches_jax(jax_vpu_cal, n_ops):
    x = torch.from_numpy(jax_vpu_cal["x"])
    assert x.shape == (P2_GRID, vpu_cal.TH, vpu_cal.TW, vpu_cal.K)
    got = vpu_cal.run(x, n_ops)
    want = jax_vpu_cal[f"run/{n_ops}"]
    assert got.shape == () and np.isfinite(want)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def numpy_run_once(x, n_ops):
    """The probe's loop as NumPy float32 statements."""
    acc = np.zeros(x.shape[1:], np.float32)
    for xi in x:
        acc = xi + acc * np.float32(1e-30)
        for j in range(n_ops // 2):
            acc = acc * xi + np.float32(j)
            acc = np.where(acc > xi, acc - xi, acc)
    return acc


@pytest.mark.parametrize("n_ops", P2_N_OPS)
def test_vpu_cal_plain_matches_numpy(n_ops):
    x = vpu_cal.make_input(P2_GRID, device="cpu")
    got = vpu_cal.run_once(x, n_ops)
    assert got.shape == (vpu_cal.TH, vpu_cal.TW, vpu_cal.K)
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(numpy_run_once(x.numpy(), n_ops)))


def test_vpu_cal_wrapper_runs_plain_on_cpu_and_refuses_the_rest():
    x = vpu_cal.make_input(2, device="cpu")
    before = counters["launch.vpu_cal"]
    assert torch.equal(vpu_cal.run_once(x, 8), vpu_cal.run_once_plain(x, 8))
    assert counters["launch.vpu_cal"] == before
    with pytest.raises(ValueError, match="CUDA device"):
        vpu_cal.run_once(x, 8, backend="cuda")
    with pytest.raises(ValueError, match="n_ops"):
        vpu_cal.run_once(x, 6)
    with pytest.raises(ValueError, match="float32"):
        vpu_cal.run_once(x[0], 8)
    with pytest.raises(ValueError, match="unsupported"):
        vpu_cal.run_once(x.to("meta"), 8)


# ---------------------------------------------------------------------------
# JAX reference for P2 (run as a script by ``jax_vpu_cal``)
# ---------------------------------------------------------------------------

def _jax_main(job_path, out_path):
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(REPO, "tools", "probes"))
    import vpu_cal as jax_vpu_cal

    jax_vpu_cal.GRID = P2_GRID                 # read when the kernel traces
    with np.load(job_path) as f:
        n_ops = [int(n) for n in f["n_ops"]]
    shape = (P2_GRID, jax_vpu_cal.TH, jax_vpu_cal.TW, jax_vpu_cal.K)
    x = jnp.linspace(0.5, 1.5, int(np.prod(shape)),
                     dtype=jnp.float32).reshape(shape)
    out = {"x": np.asarray(x)}
    with pltpu.force_tpu_interpret_mode():
        for n in n_ops:
            out[f"run/{n}"] = np.asarray(jax_vpu_cal.make(n)(x))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
