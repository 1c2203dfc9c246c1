from .permutation import (
    mimc, mimc_hash, mimc_hash_md, mimc_constants, DEFAULT_EXPONENT,
    DEFAULT_ROUNDS, DEFAULT_SEED,
)
