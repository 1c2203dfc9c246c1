"""The multi-device prover (counterpart of ``ethsnarks_tpu/parallel/``).

One process drives a :class:`.mesh.Mesh`, an ordered list of devices: each
shard is a tensor on its own device.  The reference's collectives become
device moves: a ``ppermute`` of the binary-exchange NTT is a ``.to()`` of
the partner's chunk (:mod:`.ntt_sharded`), an ``all_gather`` of the MSM
combine moves the n partial points to shard 0's device, where K1 adds them
(:mod:`.msm_red_sharded`, :mod:`.msm_sharded`).  :mod:`.qap_sharded` is the
witness map on row chunks; ``groth16.ProverContext(mesh=...)`` puts them
together.  A mesh may repeat a device (virtual shards on one card, or on
the CPU, as the tests do).
"""

from .mesh import Mesh, make_mesh  # noqa: F401
