"""The comparison that decides `correct`: each judged proof of the
program, flattened, against the plain reference's proof of the same
start values, part by part, exactly.

Each number compared counts the judged proofs that differ from the
reference in one layer of what a proof carries; its limit is 0. A
control, or a fault, makes at least one of them 1 or more; a sound run
reads 0 in all (PERF.md gives the readings)."""

from __future__ import annotations

from typing import Dict, List

LAYERS = {
    "trace_commitment": ("f_roots",),
    "composition": ("g_root",),
    "deep_values": ("f_at_z",),
    "fri_layers": ("h1_roots", "h2_roots", "fri_shape"),
    "fri_final": ("h1_final", "h2_final"),
    "openings": ("f_queries", "g_query", "h1_queries", "h2_queries"),
}


def compare(reference: dict, proofs: List[dict]) -> Dict[str, dict]:
    """{name: {"value": count, "limit": limit}}: per layer, the proofs that
    differ from the reference (limit 0), and the proofs judged (at least 1)."""
    out = {f"{layer}_mismatched": {"value": sum(any(p.get(k) != reference[k] for k in keys)
                                                for p in proofs), "limit": 0}
           for layer, keys in LAYERS.items()}
    out["proofs_judged"] = {"value": len(proofs), "limit": 1}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] >= c["limit"] if name == "proofs_judged" else c["value"] <= c["limit"]
               for name, c in checks.items())


def failed(reference: dict, proofs: List[dict]) -> int:
    """The judged proofs that differ from the reference anywhere."""
    return sum(p != reference for p in proofs)
