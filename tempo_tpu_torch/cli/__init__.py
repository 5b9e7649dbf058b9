"""Operator CLI (`cmd/tempo-cli` analog): `python -m tempo_tpu_torch.cli`."""
