"""MiMC preimage (own copy of ``ethsnarks_tpu/models/mimc_preimage.py``):
knowledge of (x, k) with E_k(x) equal to the public digest."""

from ..gadgets import MiMCe7_gadget
from ..mimc import mimc
from ..r1cs import ConstraintSystem
from ._prove import prove


class MiMCPreimage(object):
    def __init__(self):
        pb = ConstraintSystem()
        self.digest_v = pb.allocate('digest')
        pb.set_input_sizes(1)
        self.x_v = pb.allocate('x')
        self.k_v = pb.allocate('k')
        self.cipher = MiMCe7_gadget(pb, self.x_v + 0, self.k_v + 0, 'mimc')
        self.cipher.generate_r1cs_constraints()
        pb.add_constraint(self.cipher.result() + 0, 1, self.digest_v + 0,
                          'digest_bind')
        self.pb = pb

    def set_witness(self, x, k):
        pb = self.pb
        pb.setval(self.x_v, x)
        pb.setval(self.k_v, k)
        self.cipher.generate_r1cs_witness()
        pb.setval(self.digest_v, mimc(x, k))
        assert pb.is_satisfied()
        return self

    def prove(self, keypair=None, context=None, device=None, rng=None,
              msm_impl='auto'):
        """-> (proof, keypair, context); see :func:`._prove.prove`."""
        return prove(self.pb, keypair, context, device, rng, msm_impl)
