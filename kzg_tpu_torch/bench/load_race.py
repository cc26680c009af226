"""Whether a process can load the host engine's library while another
process builds it: the in-place `make -C native` of the JAX package's
loader against the port's locked build (`kzg_tpu_torch.native`).

    python3 -m kzg_tpu_torch.bench.load_race [--builds 6] [--gap 2]

1. A copy of `native/` (Makefile and source) under build/load_race/: `make
   -B` started `--builds` times two seconds apart, as test processes that
   start together each run it, while a poller loads the library with
   ctypes every 2 ms once it exists. Each make relinks the file in place.
2. The port's loader: `--builds` processes two seconds apart import
   `kzg_tpu_torch.native` and call `available()` with a fresh build
   directory, while the poller loads the path the port builds to.

Prints the loads that succeeded and failed, and the errors, for each; runs
on the CPU. A failed load is what makes the JAX package's native-gated
tests skip in one worker of a parallel run.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from .. import native

ROOT = Path(__file__).resolve().parents[2]


def poll(path: Path, stop: threading.Event, out: dict):
    """Load `path` every 2 ms until `stop`; count the outcomes."""
    while not stop.is_set():
        if path.exists():
            try:
                ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
                out["ok"] += 1
            except OSError as e:
                out["failed"] += 1
                out["errors"].add(str(e).rsplit(":", 1)[-1].strip())
        time.sleep(0.002)


def race(path: Path, cmds, gap: float):
    """Start each command `gap` seconds after the last while polling path."""
    out = {"ok": 0, "failed": 0, "errors": set()}
    stop = threading.Event()
    poller = threading.Thread(target=poll, args=(path, stop, out))
    poller.start()
    procs = []
    for cmd in cmds:
        procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        time.sleep(gap)
    for p in procs:
        p.wait()
    time.sleep(1.0)
    stop.set()
    poller.join()
    out["errors"] = sorted(out["errors"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--builds", type=int, default=6)
    ap.add_argument("--gap", type=float, default=2.0)
    args = ap.parse_args(argv)
    work = ROOT / "build" / "load_race"
    shutil.rmtree(work, ignore_errors=True)
    (work / "native").mkdir(parents=True)
    for name in ("Makefile", "kzg_native.cc"):
        shutil.copy(ROOT / "native" / name, work / "native" / name)
    make = ["make", "-s", "-B", "-C", str(work / "native")]
    in_place = race(work / "native" / "libkzg_native.so", [make] * args.builds, args.gap)

    # the port's loader, pointed at a fresh build directory of its own
    code = ("import sys; from kzg_tpu_torch import native; "
            f"native._BUILD_DIR = {str(work / 'port')!r}; "
            "sys.exit(0 if native.available() else 1)")
    native._BUILD_DIR = str(work / "port")
    locked = race(Path(native._library_path()), [[sys.executable, "-c", code]] * args.builds,
                  args.gap)
    print(json.dumps({"in_place_make": in_place, "port_locked_build": locked}))
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
