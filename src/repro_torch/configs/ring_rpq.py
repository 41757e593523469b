"""ring-rpq — the paper's own workload as a distributable config.

Not one of the 10 assigned LM architectures: this config sizes the
distributed product-graph BFS superstep (core/distributed.py) for the
dry-run/roofline, exercising the paper's technique on the production
meshes.  V/E sized to a Wikidata-class graph (Sec. 5: n ≈ 1e9 edges).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class RPQConfig:
    name: str = "ring-rpq"
    num_nodes: int = 1 << 25          # 33.5M nodes (per-pod partition)
    num_edges: int = 1 << 29          # 537M completed edges
    num_labels: int = 1024            # completed (2P)
    nfa_states: int = 16              # m+1 (16-bit D words, Sec. 5)
    supersteps: int = 8               # lowered fixed-depth for analysis


CONFIG = RPQConfig()
