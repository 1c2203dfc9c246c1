from .mimc import MiMCe7_gadget, MiMCe5_gadget, MiyaguchiPreneel_OWF, \
    MerkleDamgard_OWF
from .merkle import merkle_path_selector, merkle_path_compute, \
    merkle_path_authenticator, merkle_tree_IVs
from .basics import lookup_1bit_gadget, lookup_2bit_gadget, \
    lookup_3bit_gadget, lookup_signed_3bit_gadget, IsNonZero, \
    field2bits_strict, one_of_n, packing_gadget, boolean_constrain
from .poseidon import Poseidon_gadget
from .arith import comparison_gadget, subadd_gadget, shamir_poly
from .sha256 import sha256_full_gadget_512, sha256_many, bits2blocks_padded
