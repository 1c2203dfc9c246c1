from .mimc import MiMCe7_gadget, MiMCe5_gadget, MiyaguchiPreneel_OWF, \
    MerkleDamgard_OWF
from .merkle import merkle_path_selector, merkle_path_compute, \
    merkle_path_authenticator, merkle_tree_IVs
