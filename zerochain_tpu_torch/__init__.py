"""zerochain_tpu_torch: the PyTorch/CUDA port of zerochain_tpu.

The sub-packages carry the names of their counterparts in the JAX package:

- ``mirror``   pure-Python bigint oracle and the host verifier's pairing
- ``ff``       batched field arithmetic on 32-bit words (kernels: ``cuda_ff``)
- ``ec``       G1/G2 Jacobian group law (kernels: ``cuda_ec``), Jubjub
- ``ntt``      radix-2 NTT over Fr
- ``msm``      fixed-base and suffix-sum MSM (kernel: ``cuda_scan``)
- ``r1cs``, ``models``, ``groth16``, ``protocol``  host-side circuit code
- ``prover``   witness synthesis and the proving pipeline
- ``csrc``     the CUDA sources, built at first use by ``_build``
- ``convert``  carries limb arrays and CRS caches over from the JAX package
- ``runtime``  on-chain state machines (zk-system, balances, assets), SCALE
- ``wallet``   HD derivation, encrypted keystore (AES-128-CTR of its own),
  BIP39, SS58 addresses
- ``tx``       proof drivers and signed-extrinsic builders
- ``rpc``      JSON-RPC server and client over a runtime
- ``native``   the host C codec (bigints <-> bit/limb planes), built by cc
- ``utils``    stage timings and torch.profiler traces (``ZEROCHAIN_TRACE``)
- ``cli``      the command line, ``python -m zerochain_tpu_torch``

Entry points take an explicit ``device``; the default is the CUDA device,
and only ``device="cpu"`` selects the CPU.
"""

__version__ = "0.1.0"
