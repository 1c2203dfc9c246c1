from .permutation import (
    mimc, mimc_constants, DEFAULT_EXPONENT, DEFAULT_ROUNDS, DEFAULT_SEED,
)
