"""Command-line tools: ``verify`` (a proof against a verifying key) and
``vk2sol`` / ``proof2sol`` (Solidity for Verifier.sol), each run as
``python -m ethsnarks_tpu_torch.cli.<tool>``."""
