"""Host-side native code: the C++ OBJ line parser (``objparse_native``) and
the exact draw from torch's CPU generator (``mt_draw_native``).

Both build the same way: ``g++`` at first use into ``build/native/
lib<stem>-<hash>.so`` beside the package, the hash covering the source and
the flags, so an edited source never loads a stale library. Each build
writes a temporary file of its own and renames it into place, so processes
that build at once (test workers) never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence


def library_path(source: Path, build_dir: Path, stem: str,
                 flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return build_dir / f"lib{stem}-{digest[:16]}.so"


def build_library(cxx: str, source: Path, build_dir: Path, stem: str,
                  flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``cxx`` unless its library exists; return
    the library's path. A compiler that fails raises."""
    out = library_path(source, build_dir, stem, flags)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([cxx, *flags, str(source), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300,
                             check=False)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {source}:\n{res.stderr}")
        os.replace(tmp, out)
    return out
