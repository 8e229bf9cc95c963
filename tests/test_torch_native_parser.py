"""The port's native (C++) OBJ parser against its Python parser and the JAX
package's C++ parser.

Every case of ``tests/test_native_parser.py`` on the in-repo meshes
(``assets/*.obj``; the reference-only meshes are absent), parsed by the
port's native path and by its Python parser, array for array. The JAX
package's C++ source is built into a temporary directory by the port's own
build (importing the JAX package's binding would build into the JAX tree)
and must parse every file to the same arrays as the port's copy. Two
processes building into one empty directory at once must both load a
whole library.
"""
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_raster import REPO

from cython3dmodelrenderer_tpu_torch.models import obj_io
from cython3dmodelrenderer_tpu_torch.native import objparse_native

ASSETS = sorted(glob.glob(os.path.join(REPO, "assets", "*.obj")))
JAX_SOURCE = os.path.join(REPO, "cython3dmodelrenderer_tpu", "native",
                          "objparse.cpp")
FIELDS = ("vertices", "texture_coords", "normals", "faces_v", "faces_vt",
          "faces_vn", "texture")

EDGE = """\
    # comment
    v 0 0 0
    v 1 0 0 7.5
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vbroken line
    v oops nan_token x
    f 1 2 3 4 5
    f -3 -2 -1
    f 1 2
"""
MIXED = """\
    v 0 0 0
    v 1 0 0
    v 1 1 0
    vn 0 0 1
    vn 0 1 0
    vn 1 0 0
    f 1//1 2//2 3//3
    f 1//1 2//2 -1//-1
"""
PARTIAL_VT = """\
    v 0 0 0
    v 1 0 0
    v 1 1 0
    vt 0 0
    vt 1 0
    vt 1 1
    f 1/1 2/2 3/3
    f 1 2 3
"""
EXTRA_COMPONENTS = """\
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    vt 0 0
    vt 1 0
    vt 1 1
    vn 0 0 1
    f 1/1/1/9 2/2/1/9 3/3/1/9
    f 1/1/ 2/2/ 3/3/
    f 1// 2// 3//
    f 1/2/1/xyz 2/3/1/abc 3/1/1/!!
    f 1/2/1/ 2/3/1/ 3/1/1/
    f 1/x 2/2 3/3
    f 1/2/1x 2/2 3/3
    f 2 3 4
"""
WRITTEN = {"edge": EDGE, "mixed": MIXED, "partial_vt": PARTIAL_VT,
           "extra_components": EXTRA_COMPONENTS}


def case_path(tmp_path, name):
    """An in-repo mesh by file name, or one of ``WRITTEN`` written out."""
    if name in WRITTEN:
        path = tmp_path / f"{name}.obj"
        path.write_text(textwrap.dedent(WRITTEN[name]))
        return str(path)
    return os.path.join(REPO, "assets", name)


CASES = [os.path.basename(p) for p in ASSETS] + sorted(WRITTEN)


def assert_same_parse(nat, py):
    """Field by field, exactly (``test_native_parser.py::assert_same_parse``
    with the texture coordinates held bit-equal, not within a tolerance:
    both parse with ``strtof``-equivalent correctly rounded conversions)."""
    for field in FIELDS:
        a, b = getattr(nat, field), getattr(py, field)
        if b is None:
            assert a is None, field
        else:
            assert a is not None and a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", CASES)
def test_native_equals_python(tmp_path, name):
    """The native path against the Python parser on every in-repo mesh and
    on ``test_native_parser.py``'s edge cases, negative and mixed face
    forms, partial vt drop and extra face components."""
    path = case_path(tmp_path, name)
    nat = obj_io._try_native(path, silent=True, external_texture_filename=None)
    assert nat is not None
    assert_same_parse(nat, obj_io._load_obj_python(path))


def test_native_equals_the_jax_native_parser(tmp_path, monkeypatch):
    """The JAX package's C++ parser, built from its own source, parses every
    case to the same arrays as the port's copy; the two sources differ only
    in their header comment."""
    paths = [case_path(tmp_path, name) for name in CASES]
    port = [objparse_native.parse(p) for p in paths]
    monkeypatch.setattr(objparse_native, "SOURCE",
                        objparse_native.Path(JAX_SOURCE))
    monkeypatch.setattr(objparse_native, "BUILD_DIR", tmp_path / "jax_build")
    monkeypatch.setattr(objparse_native, "_lib", None)
    jax = [objparse_native.parse(p) for p in paths]
    assert objparse_native.library_path().parent == tmp_path / "jax_build"
    for a, b in zip(port, jax):
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y

    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("// Semantics match"):]

    assert body(JAX_SOURCE) == body(os.path.join(
        os.path.dirname(objparse_native.__file__), "objparse.cpp"))


def test_load_obj_takes_the_native_path(monkeypatch):
    """``load_obj`` parses natively where g++ exists; strict mode
    (``silent=False``) always takes the Python parser."""
    path = os.path.join(REPO, "assets", "igor_sphere.obj")

    def no_python(*args, **kwargs):
        raise AssertionError("the Python parser ran")

    monkeypatch.setattr(obj_io, "_load_obj_python", no_python)
    data = obj_io.load_obj(path)
    assert data.faces_v.shape == (6016, 3)
    monkeypatch.undo()

    def no_native(*args, **kwargs):
        raise AssertionError("the native parser ran")

    monkeypatch.setattr(objparse_native, "parse", no_native)
    strict = obj_io.load_obj(path, silent=False)
    assert_same_parse(data, strict)


def test_without_a_compiler_python_parses(monkeypatch):
    """No ``g++``: ``available()`` is False and ``load_obj`` gives the
    Python parser's arrays (the JAX package's contract)."""
    monkeypatch.setattr(objparse_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(objparse_native, "_lib", None)
    assert not objparse_native.available()
    path = os.path.join(REPO, "assets", "cube.obj")
    assert obj_io._try_native(path, True, None) is None
    assert_same_parse(obj_io.load_obj(path), obj_io._load_obj_python(path))


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory at the same time: each
    compiles to a file of its own and renames it into place, so both load
    a whole library and parse, and no temporary file is left behind."""
    build_dir = tmp_path / "build"
    path = os.path.join(REPO, "assets", "igor_sphere.obj")
    code = textwrap.dedent(f"""\
        import pathlib
        from cython3dmodelrenderer_tpu_torch.native import objparse_native as n
        n.BUILD_DIR = pathlib.Path({str(build_dir)!r})
        print(n.parse({path!r})[3].shape[0])
        """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert out.split() == ["6016"]
    assert [p.name for p in build_dir.iterdir()] == [
        objparse_native.library_path().name]
