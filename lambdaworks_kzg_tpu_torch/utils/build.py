"""Building a shared library into `_build/` safely from several processes.

The library's file name carries a digest of its sources and flags, so an
edit rebuilds. Test workers and the ranks of a process group may reach a
first build at the same time: `exclusive` makes one of them build while
the others wait, and the building process writes to a name of its own
and moves the finished file into place with one `os.replace`, so no
process ever loads a half-written library. The lock is an `flock`, which
the kernel drops when its holder dies, so a killed build leaves nothing
to clean up.
"""

import contextlib
import fcntl
import hashlib
import os


def digest_path(build_dir: str, stem: str, sources, flags) -> str:
    """`build_dir/<stem>_<16 hex digits>.so` over the flags and each
    source's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def exclusive(lib_path: str):
    """Hold an exclusive lock on `lib_path`.lock for the block."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    with open(lib_path + ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)

