"""Test-resource / archive utilities (counterpart:
``deeplearning4j_tpu/util/resources.py``; ref: nd4j-common —
org.nd4j.common.resources.Resources + strumpf resolver,
org.nd4j.common.util.ArchiveUtils).

The reference resolves named test resources from a remote artifact with
checksum verification and a local cache. Nothing here fetches from a
network: the resolver works against a local cache directory (seeded by the
user or CI), and a fetch hook is pluggable for callers that bring their
own source. Checksums use sha256 (the reference's strumpf uses sha256 too).
The cache directory and its environment variable are the JAX package's,
so one cache serves both.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import Callable, Optional


class ArchiveUtils:
    """(ref: org.nd4j.common.util.ArchiveUtils — unzip/untar helpers with
    path-traversal protection)."""

    @staticmethod
    def _check_member(dest: Path, name: str):
        target = (dest / name).resolve()
        if not str(target).startswith(str(dest.resolve()) + os.sep) \
                and target != dest.resolve():
            raise ValueError(f"archive member escapes destination: {name}")

    @staticmethod
    def unzipFileTo(archive: str, dest: str):
        destp = Path(dest)
        destp.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(archive) as zf:
            for n in zf.namelist():
                ArchiveUtils._check_member(destp, n)
            zf.extractall(destp)

    @staticmethod
    def tarGzExtractSingleFile(archive: str, dest_file: str, member: str):
        with tarfile.open(archive, "r:*") as tf:
            try:
                info = tf.getmember(member)
            except KeyError:
                raise FileNotFoundError(member) from None
            src = tf.extractfile(info)
            if src is None:
                raise FileNotFoundError(member)
            Path(dest_file).parent.mkdir(parents=True, exist_ok=True)
            with open(dest_file, "wb") as out:
                shutil.copyfileobj(src, out)

    @staticmethod
    def untarTo(archive: str, dest: str):
        destp = Path(dest)
        destp.mkdir(parents=True, exist_ok=True)
        with tarfile.open(archive, "r:*") as tf:
            # filter='data' rejects traversal, symlink-through-writes,
            # devices, and absolute names (PEP 706) — a name-only pre-scan
            # is bypassable via archive-created symlinks
            tf.extractall(destp, filter="data")

    @staticmethod
    def zipDirectory(src_dir: str, archive: str):
        srcp = Path(src_dir)
        with zipfile.ZipFile(archive, "w", zipfile.ZIP_DEFLATED) as zf:
            for f in sorted(srcp.rglob("*")):
                if f.is_file():
                    zf.write(f, f.relative_to(srcp))


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Resources:
    """(ref: org.nd4j.common.resources.Resources — `asFile("name")` resolves
    a named resource via registered resolvers; the strumpf resolver fetches
    + caches + checksum-verifies).

    Resolution order: (1) explicit cache dir (env
    DL4JTPU_RESOURCES_CACHE_DIR, default ~/.deeplearning4j_tpu/resources),
    (2) a registered fetch hook (none by default).
    """

    _fetch_hook: Optional[Callable[[str, Path], None]] = None

    @staticmethod
    def cacheDir() -> Path:
        return Path(os.environ.get(
            "DL4JTPU_RESOURCES_CACHE_DIR",
            str(Path.home() / ".deeplearning4j_tpu" / "resources")))

    @classmethod
    def registerFetchHook(cls, hook: Optional[Callable[[str, Path], None]]):
        """hook(resource_name, dest_path) — downloads into dest_path.
        Pass None to deregister."""
        cls._fetch_hook = hook

    @classmethod
    def _resolve(cls, name: str) -> Path:
        cache = cls.cacheDir()
        p = (cache / name)
        if not str(p.resolve()).startswith(str(cache.resolve()) + os.sep):
            raise ValueError(f"resource name escapes the cache dir: {name}")
        return p

    @classmethod
    def exists(cls, name: str) -> bool:
        return cls._resolve(name).exists()

    @classmethod
    def asFile(cls, name: str, sha256: Optional[str] = None,
               evictOnMismatch: bool = True) -> Path:
        p = cls._resolve(name)
        fetched = False
        if not p.exists():
            if cls._fetch_hook is None:
                raise FileNotFoundError(
                    f"resource '{name}' not in cache {cls.cacheDir()} and no "
                    "fetch hook is registered (seed the cache manually or "
                    "registerFetchHook)")
            p.parent.mkdir(parents=True, exist_ok=True)
            # fetch to a unique temp sibling and rename on success: an
            # aborted download never poses as cached, and concurrent
            # fetchers of the same name cannot clobber each other's temp
            import tempfile
            fd, tmp_name = tempfile.mkstemp(prefix=p.name + ".", suffix=".part",
                                            dir=p.parent)
            os.close(fd)
            tmp = Path(tmp_name)
            try:
                cls._fetch_hook(name, tmp)
                os.replace(tmp, p)
                fetched = True
            finally:
                tmp.unlink(missing_ok=True)
        if sha256 is not None:
            got = sha256_of(str(p))
            if got != sha256:
                # a freshly fetched artifact is certainly bad — evict it; a
                # pre-seeded file is only evicted when the caller opts in
                # (evictOnMismatch=False protects user-seeded weights)
                note = ""
                if fetched or evictOnMismatch:
                    p.unlink(missing_ok=True)
                    note = " (cached copy removed)"
                raise IOError(f"checksum mismatch for {name}: expected "
                              f"{sha256}, got {got}{note}")
        return p
