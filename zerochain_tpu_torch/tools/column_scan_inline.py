"""Run the column_scan lane loop inlined and out of line on the lanes that
made its earlier form fault.

    python3 -m zerochain_tpu_torch.tools.column_scan_inline    # needs a CUDA card

Builds ``csrc/column_scan_kernel.cu`` twice into the ignored ``_build/``
directory: as it is (the lane loop inlined, on register values) and with
the lane loop out of line (its ``ZC_HD`` swapped for ``ZC_NOINLINE``).  The
form on word arrays and pointers that came before faulted with an illegal
address in its inlined G2 build.  Each build then scans 1 program x 2
depths of G1 and of G2 points, one fresh process per case, with three
inputs in which lane 5 of every warp takes another branch of ``jac_madd``
than the warp's other lanes (which take the general add): P + P (the
doubling), P + (-P) (the identity) and P + inf (a copy).  Prints one JSON
line per case, ``fault`` or whether the words equal
``column_scan_plain``'s, then, where ``cuobjdump`` exists, one line with the
number of local loads and stores that take their address from a uniform
register in each build's two kernels.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

BUILDS = ("inline", "noinline")
CASES = ("double", "identity", "copy")


def _so(build: str) -> pathlib.Path:
    from .. import _build

    return _build.BUILD_DIR / f"libcolumn_scan_{build}_repro.so"


def build() -> None:
    """Compile both builds, the two nvcc runs side by side."""
    from .. import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "column_scan_kernel.cu").read_text()
    outlined = src.replace("ZC_HD void column_scan_lane",
                           "ZC_NOINLINE void column_scan_lane")
    if outlined == src:
        raise RuntimeError("column_scan_lane is no longer marked ZC_HD")
    procs = []
    for name, text in (("inline", src), ("noinline", outlined)):
        cu = _build.BUILD_DIR / f"column_scan_{name}_repro.cu"
        cu.write_text(text)
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(_so(name)), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")


def points(g2: bool, case: str):
    """(12, 1, 2048) leaves: depth 0 holds P_vl, depth 1 the general
    partner Q_vl, except lane 5 of every warp (P, -P or infinity)."""
    from ..ec import g1, g2 as g2mod
    from ..mirror import curves as cv

    gen = cv.G2_GEN if g2 else cv.G1_GEN
    mul = cv.g2_mul if g2 else cv.g1_mul
    neg = cv.g2_neg if g2 else cv.g1_neg
    ps = [mul(gen, 3 + 7 * k) for k in range(8)]
    qs = [mul(gen, 1000 + 7 * k) for k in range(32)]
    odd = {"double": lambda p: p, "identity": neg, "copy": lambda p: None}[case]
    depth0 = [ps[vl % 8] for vl in range(1024)]
    depth1 = [odd(ps[vl % 8]) if vl % 32 == 5 else qs[vl % 32]
              for vl in range(1024)]
    grp = g2mod if g2 else g1
    jac = grp.from_affine_host(depth0 + depth1, device="cuda")
    return tuple(
        tuple(c.reshape(12, 1, 2048) for c in comp) if isinstance(comp, tuple)
        else comp.reshape(12, 1, 2048) for comp in jac)


def run_case(build_name: str, g2: bool, case: str) -> dict:
    import torch

    from ..ec.fields import Fq2Ops, FqOps
    from ..msm import cuda_scan

    F = Fq2Ops if g2 else FqOps
    pts = points(g2, case)
    want = cuda_scan.column_scan_plain(F, pts)
    planes = [t.clone() for coord in pts for t in F.leaves(coord)]
    fn = ctypes.CDLL(str(_so(build_name))).zc_column_scan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])
    rc = fn(int(g2), ptrs, 2, 1, torch.cuda.current_stream().cuda_stream)
    out = dict(build=build_name, group="g2" if g2 else "g1", case=case,
               launch_rc=rc)
    try:
        torch.cuda.synchronize()
    except Exception as e:  # the CUDA error of a faulting launch
        return {**out, "fault": str(e).splitlines()[0]}
    wl = [t for coord in want for t in F.leaves(coord)]
    return {**out, "equal": all(torch.equal(a, b) for a, b in zip(planes, wl))}


def uniform_local_ops():
    """{build: {kernel: local loads/stores addressed by a uniform register}}
    from cuobjdump's SASS, or None without cuobjdump."""
    from .. import _build

    exe = shutil.which("cuobjdump") or str(
        pathlib.Path(_build.nvcc_path()).parent / "cuobjdump")
    if not pathlib.Path(exe).exists():
        return None
    out = {}
    for name in BUILDS:
        sass = subprocess.run([exe, "-sass", str(_so(name))], check=True,
                              capture_output=True, text=True).stdout
        per = {}
        for part in sass.split("Function : ")[1:]:
            kern = "g2" if "Fq2" in part.split("\n", 1)[0] else "g1"
            per[kern] = len(re.findall(r"\b(?:LDL|STL)\S*\s[^;]*\[UR", part))
        out[name] = per
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["case"]:
        b, g, c = sys.argv[2:5]
        print(json.dumps(run_case(b, g == "g2", c)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("column_scan_inline: needs a CUDA device", file=sys.stderr)
        return 2
    build()
    for b in BUILDS:
        for g in ("g1", "g2"):
            for c in CASES:
                r = subprocess.run(
                    [sys.executable, "-m", __spec__.name, "case", b, g, c],
                    capture_output=True, text=True, timeout=300)
                lines = [x for x in r.stdout.splitlines() if x.startswith("{")]
                print(lines[-1] if lines else json.dumps(dict(
                    build=b, group=g, case=c, exit=r.returncode,
                    stderr=r.stderr[-300:])), flush=True)
    print(json.dumps({"uniform_addressed_local_ops": uniform_local_ops()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
