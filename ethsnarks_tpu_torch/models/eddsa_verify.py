"""In-circuit EdDSA signature verification (own copy of
``ethsnarks_tpu/models/eddsa_verify.py:11-73``).

Public input: the signer's key A (x, y).  Private: R, s and the message
bits.  ``eddsa_open`` builds a throwaway constraint system with the
verify gadget, fills the witness and reports whether it is satisfied.
``EdDSAVerify(256, PureEdDSA_gadget)``, a 32-byte message, has 8,050
constraints (domain 2^13).
"""

from ..eddsa import PureEdDSA
from ..gadgets.jubjub import VariablePoint, PureEdDSA_gadget, EdDSA_gadget
from ..r1cs import ConstraintSystem
from ._prove import prove


class EdDSAVerify(object):
    def __init__(self, msg_bits_len=32, gadget_class=PureEdDSA_gadget):
        assert msg_bits_len % 8 == 0
        pb = ConstraintSystem()
        self.A = VariablePoint.allocate(pb, 'A')
        pb.set_input_sizes(2)
        self.R = VariablePoint.allocate(pb, 'R')
        self.s_bits = pb.allocate_array(254, 's')
        self.msg_bits = pb.allocate_array(msg_bits_len, 'msg')
        self.gadget = gadget_class(
            pb, PureEdDSA.B(), self.A, self.R, self.s_bits, self.msg_bits,
            'eddsa')
        self.gadget.generate_r1cs_constraints()
        self.pb = pb

    def set_witness(self, A, sig, msg, require_satisfied=True):
        """A: the key (affine Point); sig: (R, s); msg: bytes."""
        pb = self.pb
        pb.setval(self.A.x, A.x.n)
        pb.setval(self.A.y, A.y.n)
        R, s = sig
        pb.setval(self.R.x, R.x.n)
        pb.setval(self.R.y, R.y.n)
        s = int(s)
        for i in range(254):
            pb.setval(self.s_bits[i], (s >> i) & 1)
        bits = ''.join(bin(b)[2:].rjust(8, '0') for b in msg)
        assert len(bits) == len(self.msg_bits)
        for i, ch in enumerate(bits):
            pb.setval(self.msg_bits[i], int(ch))
        self.gadget.generate_r1cs_witness()
        if require_satisfied:
            assert pb.is_satisfied()
        return self

    def prove(self, keypair=None, context=None, device=None, rng=None,
              msm_impl='auto'):
        """-> (proof, keypair, context); see :func:`._prove.prove`."""
        return prove(self.pb, keypair, context, device, rng, msm_impl)


def eddsa_open(A, sig, msg, gadget_class=PureEdDSA_gadget):
    """Whether the signature satisfies the verify circuit: a bad signature
    either fails its witness generation or leaves a constraint
    unsatisfied."""
    try:
        model = EdDSAVerify(msg_bits_len=len(msg) * 8,
                            gadget_class=gadget_class)
        model.set_witness(A, sig, msg, require_satisfied=False)
    except Exception:
        return False
    return model.pb.is_satisfied()


def pureeddsa_open(A, sig, msg):
    return eddsa_open(A, sig, msg, gadget_class=PureEdDSA_gadget)


def hasheddsa_open(A, sig, msg):
    """The EdDSA variant: the message is Pedersen-hashed in the circuit."""
    return eddsa_open(A, sig, msg, gadget_class=EdDSA_gadget)
