"""Multi-device training: data parallel and the halo edge partition over
``torch.distributed``."""
