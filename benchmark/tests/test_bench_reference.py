"""The frozen plain reference against the port's plain path (its CPU form)
at a tiny size: the same outputs, loss and gradients from the same weights
and crystal; and the reference's TP pipeline in blocks against one block."""

import copy

import pytest
import torch

from bench_tiny import TINY_REPRESENTATION, tiny_cell
from harness import correct, traffic
from harness.weights import make_weights
from reference import packed_tp
from reference.build import build_model as reference_build
from reference.graph import graph_from_crystal
from reference.model import compute_losses as reference_losses


@pytest.mark.parametrize("cell_name", ["nao26-train-c512", "nao26soc-train-c512"])
def test_reference_matches_the_ports_plain_path(cell_name):
    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.models.model import compute_losses
    from hamgnn_tpu_torch.train.config import config_to_dict, load_config
    from hamgnn_tpu_torch.train.trainer import load_params

    cell = tiny_cell(cell_name)
    model_cfg = cell.config["model"]
    crystal = traffic.make_one(cell.traffic, cell.config["targets"], 5, 0)
    program = build_model(load_config(overrides=copy.deepcopy(model_cfg)))
    reference = reference_build(model_cfg)
    weights = make_weights([(n, tuple(p.shape)) for n, p in program.named_parameters()], 9,
                           "cpu")
    load_params(program, weights)
    load_params(reference, weights)
    padded = pad_and_batch([crystal], node_bucket=16, edge_bucket=256)
    graph = graph_from_crystal(crystal, "cpu")
    out_p, out_r = program(padded), reference(graph)
    for key in correct.hamiltonian_keys(cell.config):
        rows = out_r[key].shape[0]
        torch.testing.assert_close(out_p[key][:rows], out_r[key], rtol=1e-5, atol=1e-6)
    losses = [config_to_dict(x) for x in load_config(
        overrides=copy.deepcopy(model_cfg)).losses_metrics.losses]
    loss_p, _ = compute_losses(out_p, padded, losses)
    loss_r, _ = reference_losses(out_r, graph, model_cfg["losses_metrics"]["losses"])
    torch.testing.assert_close(loss_p, loss_r, rtol=1e-6, atol=0)
    loss_p.backward()
    loss_r.backward()
    grads_p = dict(program.named_parameters())
    for name, p in reference.named_parameters():
        scale = float(p.grad.abs().max()) + 1e-30
        assert float((p.grad - grads_p[name].grad).abs().max()) <= 1e-4 * scale, name


def test_blocked_pipeline_equals_one_block(monkeypatch):
    irreps = TINY_REPRESENTATION["irreps_node_features"]
    plan = packed_tp.get_plan(irreps, "0e+1o+2e", irreps, irreps)
    gen = torch.Generator().manual_seed(0)
    e = 37
    x = torch.randn(e, plan.irreps_in.dim, generator=gen, requires_grad=True)
    sh = torch.randn(e, plan.irreps_sh.dim, generator=gen)
    w = torch.randn(e, plan.weight_numel, generator=gen, requires_grad=True)
    flat = torch.randn(plan.linear_numel, generator=gen, requires_grad=True)
    gout = torch.randn(e, plan.irreps_out.dim, generator=gen)

    def run(block):
        monkeypatch.setattr(packed_tp, "EDGE_BLOCK", block)
        out = plan(x, sh, w, flat)
        grads = torch.autograd.grad(out, (x, w, flat), gout)
        return (out,) + grads

    for a, b in zip(run(8), run(1000)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
