"""Probes: measurements of one layer on the card that no serving path runs
(``python -m iron_weight_only_quant_tpu_torch.probes.<name>``)."""
