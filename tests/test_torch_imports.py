"""The port stands alone: it imports with ``jax`` and ``zerochain_tpu``
made unimportable, its sources name neither, and its entry points refuse to
run without a CUDA device unless the CPU is asked for."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "zerochain_tpu_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        if "_build" in path.relative_to(PKG).parts[:-1]:
            continue
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _import_blocked(mods):
    """Import mods in a fresh interpreter with jax, jaxlib and zerochain_tpu
    made unimportable; assert that none of them got in."""
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'zerochain_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'zerochain_tpu') for k in sys.modules)\n"
        "print('imported', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) > 30
    _import_blocked(mods)


def test_dist_imports_without_jax():
    """The multi-device package (torch.distributed) stands alone too."""
    mods = [m for m in _modules() if m.startswith("zerochain_tpu_torch.dist")]
    assert set(mods) == {"zerochain_tpu_torch.dist",
                         "zerochain_tpu_torch.dist.comm",
                         "zerochain_tpu_torch.dist.msm",
                         "zerochain_tpu_torch.dist.ntt"}
    _import_blocked(mods)


def test_sources_do_not_name_jax():
    pat = re.compile(r"^\s*(import jax|from jax|from zerochain_tpu[ .]|"
                     r"import zerochain_tpu[ .\n])|zerochain_tpu\.[a-z_]+\.",
                     re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        text = f.read_text()
        for m in pat.finditer(text):
            bad.append((str(f.relative_to(ROOT)), m.group(0).strip()))
    assert not bad, bad


@pytest.mark.parametrize("what", ["plan", "dist_ntt", "matrices", "fixed_base",
                                  "prover",
                                  "backend", "host_msm", "batch_verify",
                                  "pairing", "cli_setup", "cli_setup_default",
                                  "cli_send_default", "key_context_setup"])
def test_default_device_raises_without_cuda(what):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from zerochain_tpu_torch import cli
    from zerochain_tpu_torch.dist import DistNtt
    from zerochain_tpu_torch.ec.fields import FqOps
    from zerochain_tpu_torch.ec.pairing import pairing_host
    from zerochain_tpu_torch.models.confidential import ConfidentialTransfer
    from zerochain_tpu_torch.mirror import curves as cv
    from zerochain_tpu_torch.msm.pippenger import FixedBaseMsm
    from zerochain_tpu_torch.ntt import NttPlan
    from zerochain_tpu_torch.msm.pippenger import msm_g1
    from zerochain_tpu_torch.prover import MiniProver, TorchBackend
    from zerochain_tpu_torch.protocol.redjubjub import PrivateKey
    from zerochain_tpu_torch.protocol.redjubjub_device import batch_verify_device
    from zerochain_tpu_torch.prover.matvec import ConstraintMatrices
    from zerochain_tpu_torch.r1cs.system import ConstraintSystem
    from zerochain_tpu_torch.tx.builder import KeyContext

    make = {
        "plan": lambda: NttPlan(8),
        "dist_ntt": lambda: DistNtt(4, 4),
        "matrices": lambda: ConstraintMatrices(ConstraintSystem(), 1),
        "fixed_base": lambda: FixedBaseMsm(FqOps, cv.G1_GEN),
        "prover": lambda: MiniProver.from_toxic_waste(1, 2, 3, 4, 5),
        "backend": lambda: TorchBackend(),
        "host_msm": lambda: msm_g1([cv.G1_GEN], [3]),
        "batch_verify": lambda: batch_verify_device(
            [(PrivateKey(5).public_key(), b"m", PrivateKey(5).sign(b"m", t=bytes(80)))]),
        "pairing": lambda: pairing_host(cv.G1_GEN, cv.G2_GEN),
        # the CLI's torch backend: --device cpu is the only way to the CPU
        "cli_setup": lambda: cli.main(
            ["snark", "setup", "--backend", "torch", "--pk", "/nonexistent/pk",
             "--vk", "/nonexistent/vk"]),
        # with no --backend the CLI's setup and send go to the card too,
        # and send refuses before it reads the chain, wallet or keys
        "cli_setup_default": lambda: cli.main(
            ["snark", "setup", "--pk", "/nonexistent/pk",
             "--vk", "/nonexistent/vk"]),
        "cli_send_default": lambda: cli.main(
            ["tx", "send", "--chain", "/nonexistent/chain",
             "--pk", "/nonexistent/pk", "--vk", "/nonexistent/vk",
             "--to", "nobody", "--amount", "1"]),
        "key_context_setup": lambda: KeyContext.setup(ConfidentialTransfer),
    }[what]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
