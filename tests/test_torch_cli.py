"""The port's command line (``python -m zerochain_tpu_torch``) on the CPU.

Ungated and host-only: ``wallet recovery`` from one phrase through both
packages' ``cli.main`` lists the same accounts; a chain over the MiniCommit
fixture's prepared vk (tests/vectors/mini_vk.dat) takes ``endow``,
``next-block``, ``wallet balance`` and ``debug print-tx``; the pvk file is
the JAX package's bytes; the entry point runs with ``jax``, ``jaxlib`` and
``zerochain_tpu`` unimportable; ``--backend torch``, the default, reaches
the CPU only with ``--device cpu`` (tests/test_torch_imports.py holds the
default to the card).

Gated behind ZEROCHAIN_E2E (as tests/test_e2e_confidential.py is, ~5 min
host-only): that test's full flow on the port's CLI with ``--backend
mirror``, and the port's pk/vk files read by the JAX ``KeyContext``.
"""

import argparse
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

from zerochain_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = ROOT / "tests" / "vectors"
PHRASE = ("legal winner thank year wave sausage worth useful legal winner "
          "thank yellow")

_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'zerochain_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
)


def _run(main, argv, capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _recovered(tmp_path, capsys, main, name):
    wallet = str(tmp_path / name)
    out = _run(main, ["wallet", "recovery", "--wallet", wallet,
                      "--password", "pw", PHRASE], capsys)
    assert out == "wallet recovered\n"
    _run(main, ["wallet", "add-account", "--wallet", wallet,
                "--password", "pw", "bob"], capsys)
    return wallet, _run(main, ["wallet", "list", "--wallet", wallet], capsys)


def test_wallet_recovery_lists_as_jax(tmp_path, capsys):
    from zerochain_tpu import cli as jax_cli

    _, port = _recovered(tmp_path, capsys, cli.main, "port")
    _, ref = _recovered(tmp_path, capsys, jax_cli.main, "jax")
    assert port == ref
    lines = port.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["* default", "  bob"]


def _mini_pvk_file(tmp_path) -> str:
    """The MiniCommit fixture's vk, prepared and written by the port; the
    JAX package reads the same bytes back and writes them unchanged."""
    from zerochain_tpu.groth16 import serialization as jser
    from zerochain_tpu_torch.groth16 import serialization as ser
    from zerochain_tpu_torch.groth16.core import prepare_verifying_key

    vk = ser.vk_from_bytes((VEC / "mini_vk.dat").read_bytes())
    data = ser.pvk_to_bytes(prepare_verifying_key(vk))
    assert jser.pvk_to_bytes(jser.pvk_from_bytes(data)) == data
    path = tmp_path / "mini_pvk.dat"
    path.write_bytes(data)
    return str(path)


def test_chain_endow_balance_print_tx(tmp_path, capsys):
    wallet, listing = _recovered(tmp_path, capsys, cli.main, "w")
    addr = {ln[2:].split(":")[0]: ln.split(": ")[1]
            for ln in listing.splitlines()}
    chain = str(tmp_path / "chain")
    out = _run(cli.main, ["chain", "init", "--chain", chain,
                          "--conf-vk", _mini_pvk_file(tmp_path)], capsys)
    assert out.startswith("chain state initialized at ")
    assert _run(cli.main, ["chain", "endow", "--chain", chain,
                           addr["default"], "100"], capsys) == (
        f"endowed {addr['default']} with 100\n")
    assert _run(cli.main, ["chain", "next-block", "--chain", chain,
                           "--count", "3"], capsys) == "block height: 10\n"
    out = _run(cli.main, ["wallet", "balance", "--wallet", wallet,
                          "--password", "pw", "--chain", chain], capsys)
    assert out == "balance: 100\npending: 0\n"
    out = _run(cli.main, ["wallet", "balance", "--wallet", wallet,
                          "--password", "pw", "--chain", chain,
                          "--account", "bob"], capsys)
    assert out == "balance: 0\npending: 0\n"

    # an event in the saved state shows in print-tx
    from zerochain_tpu_torch.runtime.primitives import EncKey, ProofBytes

    path = pathlib.Path(chain) / "chain_state.pickle"
    rt = pickle.loads(path.read_bytes())
    assert type(rt).__module__ == "zerochain_tpu_torch.runtime.chain"
    rt.encrypted_balances.events.append(
        ("ConfidentialTransfer", ProofBytes(b"\xab" * 192),
         EncKey(bytes(range(32)))))
    path.write_bytes(pickle.dumps(rt))
    out = _run(cli.main, ["debug", "print-tx", "--chain", chain], capsys)
    assert out == "ConfidentialTransfer abababababababab.. 0001020304050607..\n"


def test_backend_choice():
    from zerochain_tpu_torch.groth16.core import MIRROR

    assert cli._backend(argparse.Namespace(backend="mirror", device=None)) is MIRROR
    be = cli._backend(argparse.Namespace(backend="torch", device="cpu"))
    assert type(be).__name__ == "TorchBackend" and be.device.type == "cpu"


@pytest.mark.parametrize("argv", [["--help"], ["wallet", "list"]])
def test_module_entry_point_without_jax(tmp_path, argv):
    """``python -m zerochain_tpu_torch`` (run as -m runs it) from outside
    the repository with jax, jaxlib and zerochain_tpu unimportable; these
    commands do not import torch either."""
    if argv[-1] == "list":
        subprocess.run(
            [sys.executable, "-m", "zerochain_tpu_torch", "wallet", "recovery",
             "--wallet", str(tmp_path / "w"), PHRASE],
            cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": str(ROOT)},
            check=True, capture_output=True, timeout=300)
        argv = argv + ["--wallet", str(tmp_path / "w")]
    code = _BLOCK + (
        "import runpy\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.argv = ['zerochain_tpu_torch', *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('zerochain_tpu_torch', run_name='__main__',"
        " alter_sys=True)\n"
        "finally:\n"
        "    assert not any(k.split('.')[0] in ('jax', 'zerochain_tpu')"
        " for k in sys.modules)\n"
        # the wallet's commands start without torch (seconds a process)
        "    assert 'torch' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    if argv == ["--help"]:
        assert out.stdout.startswith("usage: zerochain-tpu-torch ")
        for sub in ("snark", "wallet", "chain", "tx", "debug"):
            assert sub in out.stdout
    else:
        assert out.stdout.startswith("* default: ")


@pytest.mark.skipif(
    not os.environ.get("ZEROCHAIN_E2E"),
    reason="set ZEROCHAIN_E2E=1 to run the full end-to-end proving test",
)
def test_cli_end_to_end(tmp_path, capsys):
    """tests/test_e2e_confidential.py's flow on the port's CLI (mirror
    backend), then the port's pk/vk read by the JAX KeyContext."""
    from zerochain_tpu_torch.runtime.encrypted_balances import DispatchError
    from zerochain_tpu_torch.runtime.primitives import EncKey, Nonce, ProofBytes
    from zerochain_tpu_torch.wallet.keystore import Wallet
    from zerochain_tpu_torch.wallet.ss58 import decode_ss58

    wallet = str(tmp_path / "wallet")
    chain = str(tmp_path / "chain")
    pk = str(tmp_path / "conf_pk.dat")
    vk = str(tmp_path / "conf_vk.dat")

    cli.main(["snark", "setup", "--circuit", "confidential",
              "--pk", pk, "--vk", vk, "--backend", "mirror"])
    assert os.path.getsize(vk) == 41966  # reference PVK size parity

    cli.main(["wallet", "init", "--wallet", wallet, "--password", "pw"])
    cli.main(["wallet", "add-account", "--wallet", wallet,
              "--password", "pw", "bob"])
    accounts = {a["name"]: a["address"] for a in Wallet(wallet).list_accounts()}

    cli.main(["chain", "init", "--chain", chain, "--conf-vk", vk])
    cli.main(["chain", "endow", "--chain", chain, accounts["default"], "100"])
    out = _run(cli.main, [
        "tx", "send", "--wallet", wallet, "--password", "pw",
        "--chain", chain, "--pk", pk, "--vk", vk,
        "--to", accounts["bob"], "--amount", "30", "--backend", "mirror",
    ], capsys)
    assert "ConfidentialTransfer" in out

    bal = ["wallet", "balance", "--wallet", wallet, "--password", "pw",
           "--chain", chain]
    assert "balance: 69" in _run(cli.main, bal, capsys)
    assert "pending: 30" in _run(cli.main, bal + ["--account", "bob"], capsys)

    cli.main(["chain", "next-block", "--chain", chain, "--count", "7"])
    state = os.path.join(chain, "chain_state.pickle")
    rt = pickle.load(open(state, "rb"))
    rt.encrypted_balances.rollover(EncKey(decode_ss58(accounts["bob"])))
    pickle.dump(rt, open(state, "wb"))
    assert "balance: 30" in _run(cli.main, bal + ["--account", "bob"], capsys)

    # a corrupted proof is rejected by the on-chain verifier
    ev = rt.encrypted_balances.events[-1]
    with pytest.raises((DispatchError, Exception)):
        rt.encrypted_balances.confidential_transfer(
            ev[9],
            zkproof=ProofBytes(b"\x80" + bytes(47) + b"\x80" + bytes(95)
                               + b"\x80" + bytes(47)),
            address_sender=ev[2], address_recipient=ev[3],
            amount_sender=ev[4], amount_recipient=ev[5], fee_sender=ev[6],
            randomness=ev[7],
            nonce=(rt.zk_system.nonce_pool[0] if rt.zk_system.nonce_pool
                   else Nonce(bytes(31) + b"\x01")))

    # the files are the JAX package's: its KeyContext reads them back
    from zerochain_tpu.groth16 import serialization as jser
    from zerochain_tpu.models.confidential import ConfidentialTransfer
    from zerochain_tpu.tx.builder import KeyContext

    ctx = KeyContext.read_from_files(pk, vk, ConfidentialTransfer)
    assert jser.params_to_bytes(ctx.params) == open(pk, "rb").read()
    assert jser.pvk_to_bytes(ctx.pvk) == open(vk, "rb").read()
