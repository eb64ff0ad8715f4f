"""SCALE (parity-codec) wire formats for the chain boundary.

Byte-compatible with the reference's parity-codec derivations:
  - fixed-hash types (EncKey/SigVerificationKey/Nonce/GEpoch/Left- and
    RightCiphertext = H256, RedjubjubSignature = H512) encode as their raw
    bytes, no length prefix (core/primitives/src/enc_key.rs:43-52,
    signature.rs:46-55)
  - `Ciphertext`/`Proof` are `Vec<u8>` newtypes → compact-length prefix +
    bytes (core/primitives/src/ciphertext.rs:14-16, proof.rs:12-14)
  - dispatch calls encode as (module-variant u8, call-variant u8, args…)
    per construct_runtime! declaration order (runtime/src/lib.rs:211-229)
    and decl_module! function order
  - the signing payload is SCALE((Compact(nonce), call, era, genesis_hash))
    hashed with BLAKE2b-256, exactly the reference client's
    `raw_payload.using_encoded(|p| blake2_256(p))`
    (core/proofs/src/confidential.rs:405-419)
  - signed extrinsics use the substrate-1.0
    `UncheckedMortalCompactExtrinsic` layout (runtime/src/lib.rs:241):
    compact(len) ++ 0x81 ++ Address(0xff ++ AccountId) ++ sig(64) ++
    Compact(nonce) ++ era ++ call
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# compact integers (parity-codec "Compact<T>")
# ---------------------------------------------------------------------------


def compact_encode(n: int) -> bytes:
    if n < 0:
        raise ValueError("compact encodes unsigned integers")
    if n < 1 << 6:
        return bytes([n << 2])
    if n < 1 << 14:
        return ((n << 2) | 0b01).to_bytes(2, "little")
    if n < 1 << 30:
        return ((n << 2) | 0b10).to_bytes(4, "little")
    data = n.to_bytes((n.bit_length() + 7) // 8, "little")
    if len(data) > 67:
        raise ValueError("compact integer too large")
    return bytes([((len(data) - 4) << 2) | 0b11]) + data


def compact_decode(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, new_offset)."""
    first = data[offset]
    mode = first & 0b11
    if mode == 0b00:
        return first >> 2, offset + 1
    if mode == 0b01:
        return int.from_bytes(data[offset:offset + 2], "little") >> 2, offset + 2
    if mode == 0b10:
        return int.from_bytes(data[offset:offset + 4], "little") >> 2, offset + 4
    n_bytes = (first >> 2) + 4
    start = offset + 1
    return (int.from_bytes(data[start:start + n_bytes], "little"),
            start + n_bytes)


# ---------------------------------------------------------------------------
# primitive encoders
# ---------------------------------------------------------------------------


def encode_bytes(b: bytes) -> bytes:
    """Vec<u8>: compact length + raw bytes."""
    return compact_encode(len(b)) + bytes(b)


def decode_bytes(data: bytes, offset: int = 0) -> tuple[bytes, int]:
    n, offset = compact_decode(data, offset)
    return data[offset:offset + n], offset + n


def encode_vec(items: list[bytes]) -> bytes:
    """Vec<T> of pre-encoded items: compact count + concatenation."""
    return compact_encode(len(items)) + b"".join(items)


def encode_u32(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def encode_u64(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


ERA_IMMORTAL = b"\x00"


# ---------------------------------------------------------------------------
# call registry
# ---------------------------------------------------------------------------

# Outer Call enum variant per module, by construct_runtime! declaration
# order over Call-bearing modules (runtime/src/lib.rs:211-229).  Only the
# first four are dispatched by this framework; the SRML tail entries are
# listed for completeness of the numbering.
MODULE_INDEX = {
    "encrypted_balances": 0,
    "encrypted_assets": 1,
    "anonymous_balances": 2,
    "zk_system": 3,
    "timestamp": 4,
    "consensus": 5,
    "indices": 6,
    "balances": 7,
    "sudo": 8,
}

# (module, method) -> (call variant, ordered arg names, arg kinds)
# Arg kinds: "h256" raw 32B, "vecu8" compact-prefixed bytes, "u32",
# "vec_h256" Vec of raw-32B items.  Orders match decl_module! signatures:
#   encrypted-balances/src/lib.rs:25-35, encrypted-assets/src/lib.rs:32-41
#   /86-97/167-178, anonymous-balances/src/lib.rs:23-30/87-96.
CALL_SPECS = {
    ("encrypted_balances", "confidential_transfer"): (
        0,
        ("zkproof", "address_sender", "address_recipient", "amount_sender",
         "amount_recipient", "fee_sender", "randomness", "nonce"),
        ("vecu8", "h256", "h256", "h256", "h256", "h256", "h256", "h256"),
    ),
    ("encrypted_assets", "issue"): (
        0,
        ("zkproof", "issuer", "total", "fee", "balance", "randomness",
         "nonce"),
        ("vecu8", "h256", "h256", "h256", "vecu8", "h256", "h256"),
    ),
    ("encrypted_assets", "confidential_transfer"): (
        1,
        ("asset_id", "zkproof", "address_sender", "address_recipient",
         "amount_sender", "amount_recipient", "fee_sender", "randomness",
         "nonce"),
        ("u32", "vecu8", "h256", "h256", "h256", "h256", "h256", "h256",
         "h256"),
    ),
    ("encrypted_assets", "destroy"): (
        2,
        # reference names the third arg `id` (encrypted-assets lib.rs:171);
        # the harness spells it asset_id — wire position is identical
        ("zkproof", "owner", "asset_id", "dummy_amount", "dummy_fee",
         "dummy_balance", "randomness", "nonce"),
        ("vecu8", "h256", "u32", "h256", "h256", "vecu8", "h256", "h256"),
    ),
    ("anonymous_balances", "anonymous_transfer"): (
        0,
        ("zkproof", "enc_keys", "left_ciphertexts", "right_ciphertext",
         "nonce"),
        ("vecu8", "vec_h256", "vec_h256", "h256", "h256"),
    ),
    ("anonymous_balances", "issue"): (
        1,
        ("zkproof", "issuer", "total", "fee", "balance", "randomness",
         "nonce"),
        ("vecu8", "h256", "h256", "h256", "vecu8", "h256", "h256"),
    ),
}


def _as_bytes(v) -> bytes:
    return v.data if hasattr(v, "data") else bytes(v)


def _encode_arg(kind: str, v) -> bytes:
    if kind == "h256":
        b = _as_bytes(v)
        if len(b) != 32:
            raise ValueError(f"h256 arg must be 32 bytes, got {len(b)}")
        return b
    if kind == "vecu8":
        return encode_bytes(_as_bytes(v))
    if kind == "u32":
        return encode_u32(v)
    if kind == "vec_h256":
        return encode_vec([_encode_arg("h256", x) for x in v])
    raise ValueError(f"unknown arg kind {kind}")


def encode_call(module: str, method: str, args: dict) -> bytes:
    """SCALE bytes of Call::Module(ModuleCall::method(args…))."""
    call_idx, names, kinds = CALL_SPECS[(module, method)]
    out = bytes([MODULE_INDEX[module], call_idx])
    for name, kind in zip(names, kinds):
        out += _encode_arg(kind, args[name])
    return out


# ---------------------------------------------------------------------------
# signing payload + extrinsic
# ---------------------------------------------------------------------------


def blake2_256(data: bytes) -> bytes:
    """substrate_primitives::blake2_256 (plain BLAKE2b-256)."""
    import hashlib

    return hashlib.blake2b(data, digest_size=32).digest()


def signing_payload(nonce: int, call: bytes, genesis_hash: bytes,
                    era: bytes = ERA_IMMORTAL) -> bytes:
    """SCALE((Compact(nonce), call, era, checkpoint)) — the tuple the
    reference signs (confidential.rs:405-411)."""
    if len(genesis_hash) != 32:
        raise ValueError("genesis hash must be 32 bytes")
    return compact_encode(nonce) + call + era + genesis_hash


def signing_message(nonce: int, call: bytes, genesis_hash: bytes,
                    era: bytes = ERA_IMMORTAL) -> bytes:
    """BLAKE2b-256 of the signing payload (confidential.rs:414)."""
    return blake2_256(signing_payload(nonce, call, genesis_hash, era))


TRANSACTION_VERSION = 1


def encode_address(account_id: bytes) -> bytes:
    """generic::Address::Id — 0xff ++ 32-byte AccountId (substrate 1.0)."""
    if len(account_id) != 32:
        raise ValueError("AccountId must be 32 bytes")
    return b"\xff" + account_id


def encode_unchecked_extrinsic(nonce: int, call: bytes, signer: bytes,
                               signature: bytes,
                               era: bytes = ERA_IMMORTAL) -> bytes:
    """Signed UncheckedMortalCompactExtrinsic (substrate-1.0 layout)."""
    if len(signature) != 64:
        raise ValueError("RedjubjubSignature must be 64 bytes")
    inner = (bytes([0b1000_0000 | TRANSACTION_VERSION])
             + encode_address(signer) + signature + compact_encode(nonce)
             + era + call)
    return compact_encode(len(inner)) + inner


def decode_unchecked_extrinsic(data: bytes):
    """Inverse of encode_unchecked_extrinsic.  Returns a dict with
    signer/signature/nonce/era/call bytes."""
    total, offset = compact_decode(data, 0)
    if len(data) - offset != total:
        raise ValueError("extrinsic length prefix mismatch")
    version = data[offset]
    offset += 1
    if version & 0x7F != TRANSACTION_VERSION:
        raise ValueError(f"unsupported extrinsic version {version:#x}")
    if not version & 0x80:
        return {"signer": None, "signature": None, "nonce": None,
                "era": None, "call": data[offset:]}
    if data[offset] != 0xFF:
        raise ValueError("only AccountId addresses supported")
    signer = data[offset + 1:offset + 33]
    offset += 33
    signature = data[offset:offset + 64]
    offset += 64
    nonce, offset = compact_decode(data, offset)
    era = data[offset:offset + 1]
    if era != ERA_IMMORTAL:
        raise ValueError("only immortal era supported")
    offset += 1
    return {"signer": signer, "signature": signature, "nonce": nonce,
            "era": era, "call": data[offset:]}


def decode_call(data: bytes) -> tuple[str, str, dict]:
    """Inverse of encode_call for the six zerochain dispatchables."""
    module_idx, call_idx = data[0], data[1]
    for (module, method), (ci, names, kinds) in CALL_SPECS.items():
        if MODULE_INDEX[module] == module_idx and ci == call_idx:
            break
    else:
        raise ValueError(f"unknown call ({module_idx}, {call_idx})")
    offset = 2
    args = {}
    for name, kind in zip(names, kinds):
        if kind == "h256":
            args[name] = data[offset:offset + 32]
            offset += 32
        elif kind == "vecu8":
            args[name], offset = decode_bytes(data, offset)
        elif kind == "u32":
            args[name] = int.from_bytes(data[offset:offset + 4], "little")
            offset += 4
        elif kind == "vec_h256":
            n, offset = compact_decode(data, offset)
            args[name] = [data[offset + 32 * i:offset + 32 * (i + 1)]
                          for i in range(n)]
            offset += 32 * n
    if offset != len(data):
        raise ValueError("trailing bytes after call args")
    return module, method, args
