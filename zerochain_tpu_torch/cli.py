"""zerochain-tpu-torch command line (the zface equivalent,
zface/src/main.rs:42-917), run as ``python -m zerochain_tpu_torch``.

Subcommands: snark (trusted setup), wallet (HD keystore), chain (local
chain-state genesis/blocks), tx (build + apply confidential transfers),
debug (print-tx).  The reference's node RPC is replaced by a local
persisted Runtime (consensus/networking is a host concern, out of scope);
all proving/verifying is real.

``--backend torch`` (the default) runs the MSMs, fixed-base
exponentiations and quotient NTTs of setup and proving through
``TorchBackend`` on ``--device``, which defaults to the CUDA device and
raises where there is none: only ``--device cpu`` selects the CPU.
``--backend mirror`` runs setup and proving on host bigints.  The pk/vk files and the wallet's keyfiles are those of
the JAX package's CLI; ``chain_state.pickle`` pickles this package's
classes and is read only by this CLI.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path


def _chain_path(args) -> Path:
    return Path(args.chain) / "chain_state.pickle"


def _load_chain(args):
    with open(_chain_path(args), "rb") as f:
        return pickle.load(f)


def _save_chain(args, rt):
    _chain_path(args).parent.mkdir(parents=True, exist_ok=True)
    with open(_chain_path(args), "wb") as f:
        pickle.dump(rt, f)


def _backend(args):
    if args.backend == "torch":
        from .prover.backend import TorchBackend

        return TorchBackend(device=args.device)
    from .groth16.core import MIRROR

    return MIRROR


# ------------------------------------------------------------------ snark
def cmd_snark_setup(args):
    from .models.anonymous import AnonymousTransfer
    from .models.confidential import ConfidentialTransfer
    from .tx.builder import KeyContext

    factory = (
        ConfidentialTransfer
        if args.circuit == "confidential"
        else AnonymousTransfer
    )
    backend = _backend(args)
    print(f"running trusted setup for {args.circuit} "
          f"({args.backend} backend)...")
    ctx = KeyContext.setup(factory, backend=backend)
    ctx.write_to_files(args.pk, args.vk, factory)
    print(f"wrote proving key -> {args.pk}")
    print(f"wrote verifying key -> {args.vk}")


# ----------------------------------------------------------------- wallet
def cmd_wallet_init(args):
    from .wallet.keystore import Wallet

    w = Wallet(args.wallet)
    phrase = w.init(args.password.encode())
    print("wallet initialized; RECOVERY PHRASE (12-word BIP39 mnemonic), "
          "store it safely:")
    print(phrase)


def cmd_wallet_recovery(args):
    from .wallet.keystore import Wallet

    Wallet(args.wallet).recover(args.password.encode(), args.phrase)
    print("wallet recovered")


def cmd_wallet_list(args):
    from .wallet.keystore import Wallet

    for acc in Wallet(args.wallet).list_accounts():
        star = "*" if acc["default"] else " "
        print(f"{star} {acc['name']}: {acc['address']}")


def cmd_wallet_add_account(args):
    from .wallet.keystore import Wallet

    addr = Wallet(args.wallet).add_account(args.name, args.password.encode())
    print(f"added account {args.name}: {addr}")


def cmd_wallet_change_account(args):
    from .wallet.keystore import Wallet

    Wallet(args.wallet).change_account(args.name)
    print(f"default account is now {args.name}")


def cmd_wallet_balance(args):
    from .protocol.elgamal import Ciphertext
    from .protocol.keys import ProofGenerationKey
    from .runtime.primitives import CiphertextBytes
    from .wallet.keystore import Wallet

    rt = _load_chain(args)
    w = Wallet(args.wallet)
    sk = w.spending_key(args.password.encode(), args.account)
    pgk = ProofGenerationKey.from_spending_key(sk)
    dk = pgk.into_decryption_key()
    ek = pgk.into_encryption_key()
    key = ek.to_bytes()

    def dec(ctb):
        if ctb is None:
            return 0
        ct = Ciphertext(ctb.left().to_point(), ctb.right().to_point())
        v = ct.decrypt(dk)
        return v if v is not None else "<undecryptable>"

    bal = rt.encrypted_balances.encrypted_balance.get(key)
    pend = rt.encrypted_balances.pending_transfer.get(key)
    print(f"balance: {dec(bal)}")
    print(f"pending: {dec(pend)}")


# ------------------------------------------------------------------ chain
def cmd_chain_init(args):
    from .groth16 import serialization as ser
    from .runtime.chain import Runtime

    conf_vk = ser.pvk_from_bytes(open(args.conf_vk, "rb").read())
    anon_vk = (
        ser.pvk_from_bytes(open(args.anon_vk, "rb").read())
        if args.anon_vk
        else None
    )
    rt = Runtime(conf_vk, anon_vk, epoch_length=args.epoch_length)
    rt.set_block(args.epoch_length)  # start past the epoch-0 nonce quirk
    _save_chain(args, rt)
    print(f"chain state initialized at {_chain_path(args)}")


def cmd_chain_endow(args):
    """Genesis endowment: set an encrypted balance directly."""
    from .protocol.elgamal import Ciphertext
    from .protocol.keys import EncryptionKey
    from .mirror import jubjub as jj
    from .runtime.primitives import CiphertextBytes
    from .wallet.ss58 import decode_ss58

    rt = _load_chain(args)
    ek = EncryptionKey.from_bytes(decode_ss58(args.address))
    ct = Ciphertext.encrypt(args.amount, 1, ek)
    rt.encrypted_balances.encrypted_balance[ek.to_bytes()] = CiphertextBytes(
        jj.to_bytes(ct.left) + jj.to_bytes(ct.right)
    )
    _save_chain(args, rt)
    print(f"endowed {args.address} with {args.amount}")


def cmd_chain_next_block(args):
    rt = _load_chain(args)
    for _ in range(args.count):
        rt.next_block()
    _save_chain(args, rt)
    print(f"block height: {rt.block_number}")


# --------------------------------------------------------------------- tx
def cmd_tx_send(args):
    from .models.confidential import ConfidentialTransfer
    from .protocol.elgamal import Ciphertext
    from .protocol.keys import EncryptionKey, ProofGenerationKey
    from .tx.builder import KeyContext, build_confidential_xt
    from .wallet.keystore import Wallet
    from .wallet.ss58 import decode_ss58

    backend = _backend(args)
    rt = _load_chain(args)
    w = Wallet(args.wallet)
    sk = w.spending_key(args.password.encode(), args.account)
    pgk = ProofGenerationKey.from_spending_key(sk)
    dk = pgk.into_decryption_key()
    ek_sender = pgk.into_encryption_key()
    recipient = EncryptionKey.from_bytes(decode_ss58(args.to))

    ctb = rt.encrypted_balances.encrypted_balance.get(ek_sender.to_bytes())
    pend = rt.encrypted_balances.pending_transfer.get(ek_sender.to_bytes())
    if ctb is None:
        print("no balance for sender", file=sys.stderr)
        sys.exit(1)
    if pend is not None:
        ctb = ctb.add(pend)  # what rollover will produce on-chain
    balance_ct = Ciphertext(ctb.left().to_point(), ctb.right().to_point())
    current = balance_ct.decrypt(dk)
    fee = rt.encrypted_balances.transaction_base_fee
    remaining = current - args.amount - fee
    if remaining < 0:
        print(f"insufficient balance: {current}", file=sys.stderr)
        sys.exit(1)

    ctx = KeyContext.read_from_files(args.pk, args.vk, ConfidentialTransfer)
    from .runtime.primitives import GEpochBytes

    epoch = rt.block_number // rt.zk_system.epoch_length
    g_epoch = GEpochBytes.group_hash(epoch).to_point()

    print(f"proving confidential transfer of {args.amount} "
          f"(+{fee} fee), remaining {remaining}...")
    xt = build_confidential_xt(
        ctx,
        amount=args.amount,
        remaining_balance=remaining,
        spending_key=sk,
        enc_key_recipient=recipient,
        encrypted_balance=balance_ct,
        g_epoch=g_epoch,
        fee=fee,
        backend=backend,
    )
    rt.apply_extrinsic(xt.to_extrinsic(
        nonce_index=rt.account_nonce.get(xt.rvk, 0)
    ))
    _save_chain(args, rt)
    print("transfer applied; events:",
          [e[0] for e in rt.encrypted_balances.events[-1:]])


# ------------------------------------------------------------------ debug
def cmd_debug_print_tx(args):
    rt = _load_chain(args)
    for ev in rt.encrypted_balances.events:
        print(ev[0], *[
            (x.data.hex()[:16] + "..") if hasattr(x, "data") else x
            for x in ev[1:3]
        ])


def main(argv=None):
    p = argparse.ArgumentParser(prog="zerochain-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    # snark
    ps = sub.add_parser("snark", help="trusted setup")
    ss = ps.add_subparsers(dest="sub", required=True)
    s1 = ss.add_parser("setup")
    s1.add_argument("--circuit", choices=["confidential", "anonymous"],
                    default="confidential")
    s1.add_argument("--pk", required=True)
    s1.add_argument("--vk", required=True)
    s1.add_argument("--backend", choices=["mirror", "torch"], default="torch")
    s1.add_argument("--device", default=None,
                    help="torch backend's device (default: the CUDA device; "
                         "'cpu' selects the CPU)")
    s1.set_defaults(fn=cmd_snark_setup)

    # wallet
    pw = sub.add_parser("wallet", help="HD keystore")
    sw = pw.add_subparsers(dest="sub", required=True)
    for name, fn, extra in [
        ("init", cmd_wallet_init, []),
        ("recovery", cmd_wallet_recovery, ["phrase"]),
        ("list", cmd_wallet_list, []),
        ("add-account", cmd_wallet_add_account, ["name"]),
        ("change-account", cmd_wallet_change_account, ["name"]),
        ("balance", cmd_wallet_balance, []),
    ]:
        sp = sw.add_parser(name)
        sp.add_argument("--wallet", default="./wallet")
        if name not in ("list", "change-account"):
            sp.add_argument("--password", default="")
        for e in extra:
            sp.add_argument(e)
        if name == "balance":
            sp.add_argument("--chain", default="./chain")
            sp.add_argument("--account", default=None)
        sp.set_defaults(fn=fn)

    # chain
    pc = sub.add_parser("chain", help="local chain state")
    sc = pc.add_subparsers(dest="sub", required=True)
    c1 = sc.add_parser("init")
    c1.add_argument("--chain", default="./chain")
    c1.add_argument("--conf-vk", required=True)
    c1.add_argument("--anon-vk", default=None)
    c1.add_argument("--epoch-length", type=int, default=7)
    c1.set_defaults(fn=cmd_chain_init)
    c2 = sc.add_parser("endow")
    c2.add_argument("--chain", default="./chain")
    c2.add_argument("address")
    c2.add_argument("amount", type=int)
    c2.set_defaults(fn=cmd_chain_endow)
    c3 = sc.add_parser("next-block")
    c3.add_argument("--chain", default="./chain")
    c3.add_argument("--count", type=int, default=1)
    c3.set_defaults(fn=cmd_chain_next_block)

    # tx
    pt = sub.add_parser("tx", help="transactions")
    st = pt.add_subparsers(dest="sub", required=True)
    t1 = st.add_parser("send")
    t1.add_argument("--wallet", default="./wallet")
    t1.add_argument("--password", default="")
    t1.add_argument("--account", default=None)
    t1.add_argument("--chain", default="./chain")
    t1.add_argument("--pk", required=True)
    t1.add_argument("--vk", required=True)
    t1.add_argument("--to", required=True)
    t1.add_argument("--amount", type=int, required=True)
    t1.add_argument("--backend", choices=["mirror", "torch"], default="torch")
    t1.add_argument("--device", default=None,
                    help="torch backend's device (default: the CUDA device; "
                         "'cpu' selects the CPU)")
    t1.set_defaults(fn=cmd_tx_send)

    # debug
    pd = sub.add_parser("debug")
    sd = pd.add_subparsers(dest="sub", required=True)
    d1 = sd.add_parser("print-tx")
    d1.add_argument("--chain", default="./chain")
    d1.set_defaults(fn=cmd_debug_print_tx)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
