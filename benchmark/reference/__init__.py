"""The plain reference: ACM-GCN+ / ACM-GCN++ (Luan et al., NeurIPS 2022,
arXiv:2210.07606), its operators, dropout and Adam in plain PyTorch.  It
imports nothing of the program and nothing of JAX."""
