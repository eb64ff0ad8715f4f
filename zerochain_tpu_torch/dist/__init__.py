"""Multi-device scaling over ``torch.distributed``: sharded MSMs and the
four-step distributed NTT (the counterpart of ``zerochain_tpu.dist``).

The JAX package shards over a ``jax.sharding.Mesh`` axis inside
``shard_map``; here each rank of a process group runs the same call on its
own device.  ``group=None`` means the default group.  Every rank passes the
whole replicated input and gets the whole replicated output:

- ``msm``: each rank computes its ``N / n`` slice of the points, the
  partial points are all-gathered and added in rank order
  (``sharded_msm``, ``sharded_msm_g1``, ``sharded_suffix``);
- ``ntt``: the four-step transform, rows split over the ranks, one
  all-to-all between the two local transforms and one all-gather at the end
  (``DistNtt``, ``dist_plan_for``, ``distributed_ntt``);
- ``comm``: the two collectives, their backend check and their counts.

A world on CPU tensors runs over gloo, on the card over NCCL; a world of
one needs no network (``init_method="file://..."``).
"""

from .msm import sharded_msm, sharded_msm_g1, sharded_suffix  # noqa: F401
from .ntt import DistNtt, dist_plan_for, distributed_ntt  # noqa: F401
