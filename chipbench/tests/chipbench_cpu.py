"""Helpers of the CPU tests: a cell run on the CPU at the port's smoke
size, skipping the look for a card."""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def smoke_config(arch: str, **port_overrides) -> dict:
    """A configuration file for the port's smoke config of ``arch``."""
    from repro_torch.configs import get_smoke_config
    c = get_smoke_config(arch)
    out = {"hidden_size": c.d_model, "num_hidden_layers": c.num_layers,
           "num_attention_heads": c.num_heads,
           "num_key_value_heads": c.num_kv_heads,
           "head_dim": c.resolved_head_dim, "vocab_size": c.vocab_size,
           "rms_norm_eps": c.norm_eps, "rope_theta": c.rope_theta,
           "tie_word_embeddings": c.tie_embeddings,
           "port": {"arch": arch, "smoke": True,
                    "overrides": port_overrides}}
    if c.family == "moe":
        out.update(num_experts=c.num_experts,
                   num_experts_per_tok=c.num_experts_per_tok,
                   moe_intermediate_size=c.d_ff)
        out["port"]["overrides"].setdefault(
            "moe_capacity_factor", c.num_experts / c.num_experts_per_tok)
    else:
        out["intermediate_size"] = c.d_ff
    return out


def serve_smoke(cell) -> None:
    cell.config = smoke_config("qwen2-0.5b")
    cell.spec = dict(cell.spec, clients=4, block=8,
                     prompt_len={"median": 12, "sigma": 0.5, "min": 6,
                                 "max": 20},
                     output_len={"median": 8, "sigma": 0.5, "min": 6,
                                 "max": 12},
                     first_horizon=6,
                     engine=dict(cell.spec["engine"], max_slots=4,
                                 max_seq_len=64),
                     check=dict(cell.spec["check"], requests=3))


def train_smoke(cell) -> None:
    cell.config = smoke_config("qwen2-0.5b")
    cell.spec = dict(cell.spec, global_batch=4, seq_len=32, pool_steps=4,
                     check=dict(cell.spec["check"], rows=2))


def run_smoke(name: str, seed: int = 3, seconds: float = 2.0, hook=None):
    """Run ``name`` on the CPU at smoke size; one intra-op thread, so that
    test workers sharing the host do not starve each other's windows."""
    import torch
    from chipbench import core
    base = serve_smoke if "clients" in name else train_smoke

    def edit(cell):
        base(cell)
        if hook is not None:
            hook(cell)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return core.run_cell(ROOT, name, seed, seconds, False, device="cpu",
                             overrides=edit)
    finally:
        torch.set_num_threads(threads)
