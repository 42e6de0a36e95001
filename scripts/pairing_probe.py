#!/usr/bin/env python3
"""Where the pairing kernels' time goes, on a CUDA card. At B = 2 (a
verification's true check, points with Z != 1), pairing_miller_loop and
pairing_final_exp run their level programs once through the wrappers,
held against the plain versions limb for limb, and are timed; then the
same launches with parts of the program emptied (timing only; those
outputs are not results):

- by subroutine: the Miller loop with its affine subroutine alone (two
  inversions and a few levels) and without it, the final exponentiation
  with only its easy part (one inversion) and without it, and both with
  every subroutine empty (the launch, the loads and stores);
- by phase kind: the entry count of every linear phase, of every
  product phase, or of both set to zero (the phases still sync).

Also prints ptxas' registers and spills of both kernels and the levels,
linear waves, products and inversions of each run. Run from the
repository root:

    python3 scripts/pairing_probe.py

The last line is one JSON object: per kernel the ms per launch (CUDA
events behind a spin, 20 launches, two turns), its counts and the us per
level, and the two splits in ms per launch.
"""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pairing_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    from chip_smoke import ptxas_report
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb, pairing_ops
    from lambdaworks_kzg_tpu_torch.ops import pairing_levels as PL
    from lambdaworks_kzg_tpu_torch.utils.profiling import time_ms

    info = kernels.build()
    out = {"card": card, "pairs": 2, "ptxas": {}}
    for name in ("pairing_miller_loop", "pairing_final_exp"):
        out["ptxas"][name] = ptxas_report(info["log"], name + "_kernel")
    print(out["ptxas"], flush=True)
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pairs = [(HC.point_neg(HC.point_scalar_mul(G, 13 * 29)), G2),
             (HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29))]
    ps, qs = pairing_ops.jacobian_lanes(pairs, "cuda", seed=2)
    ps32, qs32 = lb.to_u32_layout(ps), lb.to_u32_layout(qs)
    f_plain = pairing_ops.miller_loop_jac(ps, qs)
    fe_plain, _ = pairing_ops.final_exp_check(f_plain)
    f32 = kernels.miller_loop(ps32, qs32)
    fe32, ok = kernels.final_exp(f32)
    if not (torch.equal(lb.to_u16_layout(f32), f_plain)
            and torch.equal(lb.to_u16_layout(fe32), fe_plain) and ok.tolist() == [True]):
        raise AssertionError("the pairing kernels differ from the plain versions")
    miller, fe = PL.programs()
    counts = {"pairing_miller_loop": PL.count(miller, PL.miller_calls()),
              "pairing_final_exp": PL.count(fe, PL.final_exp_calls(2))}
    for name, fn in (("pairing_miller_loop", lambda: kernels.miller_loop(ps32, qs32)),
                     ("pairing_final_exp", lambda: kernels.final_exp(f32))):
        ms = [time_ms(fn, 20) for _ in range(2)]
        c = counts[name]
        out[name] = {"ms": ms, **c, "us_per_level": min(ms) * 1e3 / c["levels"]}
        print(name, out[name], flush=True)

    # the same launches on an edited program (the wrappers' first calls
    # above copied the full programs and set the kernels' shared memory,
    # which an edit of counts leaves the same size)
    m_out = torch.empty((12, kernels.NL, 2), dtype=torch.int32, device="cuda")
    fe_out = torch.empty((12, kernels.NL, 1), dtype=torch.int32, device="cuda")
    fe_ok = torch.empty(1, dtype=torch.bool, device="cuda")
    gamma = kernels._gamma(f32.device)

    def launcher(which: int, words: list):
        prog = miller if which == 0 else fe
        t = torch.tensor(words, dtype=torch.int32, device="cuda")
        smem = (prog.slots * PL.WORDS + len(words)) * 4
        if which == 0:
            return lambda: kernels._run("miller_loop", ps32, ps32.data_ptr(), qs32.data_ptr(),
                                        m_out.data_ptr(), 2, PL.X_ABS, t.data_ptr(), t.numel(),
                                        smem)
        return lambda: kernels._run("final_exp", f32, f32.data_ptr(), gamma.data_ptr(),
                                    fe_out.data_ptr(), fe_ok.data_ptr(), 2, PL.X_ABS, PL.XM1_ABS,
                                    t.data_ptr(), t.numel(), smem)

    def only(which: int, keep) -> list:
        """The program with every subroutine outside `keep` emptied."""
        prog = miller if which == 0 else fe
        words = list(prog.words)
        for i, sub in enumerate(prog.subs):
            if sub.name not in keep:
                words[PL.H_SUBS + 2 * i + 1] = 0
        return words

    def zeroed(which: int, kinds) -> list:
        """The program with the entry count of every phase of these kinds
        set to zero."""
        prog = miller if which == 0 else fe
        words = list(prog.words)
        table = words[PL.H_TABLE]
        for i in range(sum(len(sub.phases) for sub in prog.subs)):
            if words[table + 4 * i] in kinds:
                words[table + 4 * i + 1] = 0
        return words

    split = {}
    for label, which, keep in (("miller_affine_only", 0, {"affine"}),
                               ("miller_without_affine", 0, {"dbl", "add", "final"}),
                               ("miller_empty", 0, set()),
                               ("final_exp_easy_only", 1, {"easy"}),
                               ("final_exp_without_easy", 1, set(PL.FE_SUBS) - {"easy"}),
                               ("final_exp_empty", 1, set())):
        split[label] = [time_ms(launcher(which, only(which, keep)), 20) for _ in range(2)]
    out["split_ms"] = split
    print("split", split, flush=True)
    by_kind = {}
    for label, kinds in (("no_lin", {PL.LIN}), ("no_mul", {PL.MUL}),
                         ("syncs_only", {PL.LIN, PL.MUL})):
        for which, name in ((0, "miller"), (1, "final_exp")):
            by_kind[f"{name}_{label}"] = time_ms(launcher(which, zeroed(which, kinds)), 20)
    out["by_kind_ms"] = by_kind
    print("by kind", by_kind, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
