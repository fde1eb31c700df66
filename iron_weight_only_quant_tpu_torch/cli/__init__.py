"""Command-line entry points of the port (the JAX package's commands, on
the card by default; ``--platform cpu`` runs the plain PyTorch path):

  python -m iron_weight_only_quant_tpu_torch.cli.quantize       checkpoint -> packed artifact
  python -m iron_weight_only_quant_tpu_torch.cli.generate       text generation / engine demo
  python -m iron_weight_only_quant_tpu_torch.cli.eval_ppl       PPL sweeps (bits x format x group)
  python -m iron_weight_only_quant_tpu_torch.cli.eval_zeroshot  zero-shot task suite
  python -m iron_weight_only_quant_tpu_torch.cli.sweep          runs of eval_ppl from a JSON file
"""
