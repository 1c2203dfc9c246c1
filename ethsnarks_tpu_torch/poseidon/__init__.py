from .permutation import (
    poseidon, poseidon_params, poseidon_constants, poseidon_matrix,
    PoseidonParamsType, DefaultParams,
)
