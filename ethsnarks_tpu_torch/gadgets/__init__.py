from .mimc import MiMCe7_gadget
