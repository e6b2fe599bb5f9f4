"""The system under test, hodor_tpu_torch, as the benchmark drives it:
its witness models, its Prover, its spans (Prover.last_timings) and its
counters (field.kernels.launch_counts, profiling.form_counts). Nothing
else of the program is read."""

from __future__ import annotations

from typing import Dict, List

import torch


class Program:
    """The witnesses of the pool, built at set-up on `device` with the
    program's own model (evaluating the VDF is the client's work). Every
    call is a new VDF instance to the program, as each request of a
    deployment is one: it builds the instance's Prover, proves, and lets
    the Prover go, so one Prover lives at a time."""

    def __init__(self, config: dict, log_rows: int, starts, device: torch.device):
        import hodor_tpu_torch.field as field_mod
        import hodor_tpu_torch.models as models
        from hodor_tpu_torch.field import kernels
        from hodor_tpu_torch.utils.native import build_host_library

        port = config["port"]
        if device.type == "cuda":
            kernels.build_kernels()
        build_host_library()
        field = getattr(field_mod, port["field"])
        model = getattr(models, port["model"])
        self.device = device
        self.lde_factor = config["lde_factor"]
        self.final_dp1 = config["fri_final_degree_plus_one"]
        self.witnesses, self.instances = [], []
        for c0, c1 in starts:
            witness, props = model(field, c0, c1, (1 << log_rows) - 1).into_arp()
            self.witnesses.append(witness)
            self.instances.append(props)
        self.last_timings: Dict[str, float] = {}

    def call(self, idx: List[int]) -> list:
        """The proofs of the witnesses idx, one call of the program ended by
        a synchronize: the Prover of witness idx[0]'s instance, then its
        prove (one lane) or prove_batch (more, all under that instance)."""
        from hodor_tpu_torch.prover import Prover

        prover = Prover(self.instances[idx[0]].clone(), lde_factor=self.lde_factor,
                        fri_final_degree_plus_one=self.final_dp1, device=self.device)
        if len(idx) == 1:
            proofs = [prover.prove(self.witnesses[idx[0]])]
        else:
            proofs = prover.prove_batch([self.witnesses[i] for i in idx])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_timings = prover.last_timings.as_dict()
        return proofs

    def last_stages(self) -> Dict[str, float]:
        """Seconds by stage of the last call (its StageTimer)."""
        return self.last_timings

    @staticmethod
    def counters() -> Dict[str, Dict[str, int]]:
        from hodor_tpu_torch.field import kernels
        from hodor_tpu_torch.profiling import form_counts

        return {"launches": dict(kernels.launch_counts), "forms": dict(form_counts)}


def counters_since(before: dict, after: dict) -> dict:
    return {k: {name: after[k][name] - before[k].get(name, 0) for name in after[k]}
            for k in after}


def flatten(proof) -> dict:
    """A proof of the program as plain values, in the judge's form."""
    def opening(q):
        return [q.index, q.value, [b.hex() for b in q.path]]

    fri = (proof.fri_proof_h1, proof.fri_proof_h2)
    return {
        "f_roots": [r.hex() for r in proof.f_iop_roots],
        "g_root": proof.g_iop_root.hex(),
        "f_at_z": list(proof.f_at_z_m),
        "h1_roots": [r.hex() for r in proof.h1_iop_roots],
        "h2_roots": [r.hex() for r in proof.h2_iop_roots],
        "h1_final": list(fri[0].final_coefficients),
        "h2_final": list(fri[1].final_coefficients),
        "f_queries": [opening(q) for q in proof.f_queries],
        "g_query": opening(proof.g_query),
        "h1_queries": [opening(q) for q in fri[0].queries],
        "h2_queries": [opening(q) for q in fri[1].queries],
        "fri_shape": [[f.initial_degree_plus_one, f.output_coeffs_at_degree_plus_one,
                       f.lde_factor] for f in fri],
    }
