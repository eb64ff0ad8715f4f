"""JSON-RPC boundary between the client stack and the chain runtime.

The reference splits prover-host and chain across a websocket JSON-RPC
boundary (polkadot-rs: Api::{get_storage,get_nonce,submit_extrinsic,
get_genesis_blockhash}, SURVEY.md §2.3).  This module reproduces that
process boundary over HTTP with the stdlib: `RpcServer` wraps a runtime
instance, `RpcClient` mirrors the polkadot-rs Api surface.  Values cross
the wire hex-encoded.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import Request, urlopen

from .runtime.chain import Extrinsic, Runtime
from .runtime.primitives import (
    CiphertextBytes,
    EncKey,
    LeftCiphertext,
    Nonce,
    ProofBytes,
    RightCiphertext,
    SigVerificationKey,
)
from .protocol.redjubjub import Signature

_ARG_TYPES = {
    "zkproof": ProofBytes,
    "address_sender": EncKey,
    "address_recipient": EncKey,
    "issuer": EncKey,
    "owner": EncKey,
    "amount_sender": LeftCiphertext,
    "amount_recipient": LeftCiphertext,
    "fee_sender": LeftCiphertext,
    "total": LeftCiphertext,
    "fee": LeftCiphertext,
    "dummy_amount": LeftCiphertext,
    "dummy_fee": LeftCiphertext,
    "randomness": RightCiphertext,
    "right_ciphertext": RightCiphertext,
    "nonce": Nonce,
    "balance": CiphertextBytes,
    "dummy_balance": CiphertextBytes,
    "enc_keys": EncKey,
    "left_ciphertexts": LeftCiphertext,
}


def _decode_arg(name, value):
    t = _ARG_TYPES.get(name)
    if t is None:
        return value
    if isinstance(value, list):
        return [t(bytes.fromhex(v)) for v in value]
    return t(bytes.fromhex(value))


class RpcServer:
    """Serves a Runtime over JSON-RPC (the node side of the boundary)."""

    def __init__(self, runtime: Runtime, host="127.0.0.1", port=0):
        self.runtime = runtime
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                length = int(self.headers["Content-Length"])
                req = json.loads(self.rfile.read(length))
                try:
                    result = outer._dispatch(req["method"], req.get("params", {}))
                    body = {"jsonrpc": "2.0", "id": req.get("id"),
                            "result": result}
                except Exception as e:  # noqa: BLE001
                    body = {
                        "jsonrpc": "2.0", "id": req.get("id"),
                        "error": {"code": -32000, "message": str(e)},
                    }
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()

    # ------------------------------------------------------------------
    def _dispatch(self, method, params):
        rt = self.runtime
        if method == "chain_getBlockNumber":
            return rt.block_number
        if method == "state_getStorage":
            module = getattr(rt, params["module"])
            store = getattr(module, params["storage"])
            key = bytes.fromhex(params["key"]) if "key" in params else None
            val = store.get(key) if key is not None else store
            if val is None:
                return None
            if hasattr(val, "data"):
                return val.data.hex()
            return val
        if method == "system_accountNonce":
            return rt.account_nonce.get(bytes.fromhex(params["rvk"]), 0)
        if method == "chain_getGenesisHash":
            return "00" * 32  # local simulation: fixed genesis id
        if method == "author_submitExtrinsic":
            xt = Extrinsic(
                module=params["module"],
                method=params["method"],
                args={
                    k: _decode_arg(k, v) for k, v in params["args"].items()
                },
                rvk=SigVerificationKey(bytes.fromhex(params["rvk"])),
                nonce_index=params["nonce_index"],
            )
            xt.signature = Signature.from_bytes(
                bytes.fromhex(params["signature"])
            )
            rt.apply_extrinsic(xt)
            return "ok"
        raise ValueError(f"unknown method {method}")


class RpcClient:
    """The polkadot-rs `Api` equivalent (client side)."""

    def __init__(self, url: str):
        self.url = url
        self._id = 0

    def _call(self, method, params):
        self._id += 1
        req = Request(
            self.url,
            data=json.dumps(
                {"jsonrpc": "2.0", "id": self._id, "method": method,
                 "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        if "error" in body:
            raise RuntimeError(body["error"]["message"])
        return body["result"]

    def get_block_number(self) -> int:
        return self._call("chain_getBlockNumber", {})

    def get_storage(self, module: str, storage: str, key: bytes | None = None):
        params = {"module": module, "storage": storage}
        if key is not None:
            params["key"] = key.hex()
        return self._call("state_getStorage", params)

    def get_nonce(self, rvk: bytes) -> int:
        return self._call("system_accountNonce", {"rvk": rvk.hex()})

    def get_genesis_blockhash(self) -> bytes:
        return bytes.fromhex(self._call("chain_getGenesisHash", {}))

    def submit_extrinsic(self, xt: Extrinsic) -> str:
        assert xt.signature is not None, "extrinsic must be signed"
        args = {}
        for k, v in xt.args.items():
            if isinstance(v, list):
                args[k] = [x.data.hex() for x in v]
            elif hasattr(v, "data"):
                args[k] = v.data.hex()
            else:
                args[k] = v
        return self._call(
            "author_submitExtrinsic",
            {
                "module": xt.module,
                "method": xt.method,
                "args": args,
                "rvk": xt.rvk.data.hex(),
                "nonce_index": xt.nonce_index,
                "signature": xt.signature.to_bytes().hex(),
            },
        )
