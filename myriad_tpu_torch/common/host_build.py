"""Host C++ libraries of the port, built at first use and loaded with ``ctypes``.

A source under ``csrc/`` (plain C interface, no PyTorch headers) is compiled
with the host C++ compiler (``$CXX``, else ``c++``) into ``build/host/``
beside the package, under a name that carries a digest of the compiler, the
flags and the source, so an edited source builds anew.  Builds from several
processes take one file lock, so concurrent first uses compile once.
Without a compiler ``build`` raises and names it: nothing falls back to
another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` on the PATH."""
    name = os.environ.get("CXX") or "c++"
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"the port's host libraries are built with a host C++ compiler, "
                           f"and {name!r} was not found (set CXX)")
    return path


class HostLibrary:
    """One source, its shared library under ``build/host/`` and its
    functions' ``ctypes`` signatures ({name: (argtypes, restype)})."""

    def __init__(self, source: Path, stem: str, signatures: Dict[str, Tuple[List, object]]):
        self.source, self.stem, self.signatures = source, stem, signatures
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> Path:
        """Compile the source once per digest; returns the library's path."""
        cxx = compiler()
        digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode()
                                + self.source.read_bytes())
        out = BUILD_DIR / f"{self.stem}-{digest.hexdigest()[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{self.stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():  # another process may have built it meanwhile
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(self.source)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{cxx} failed on {self.source.name} ({res.returncode}):"
                                       f"\n{res.stdout}{res.stderr}")
                os.replace(tmp, out)
        return out

    def library(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (args, res) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = res
                self._lib = lib
        return self._lib
