#!/usr/bin/env python3
"""The multi-device prover on every card of one machine.

    python3 chip_mesh.py

``chip_smoke.py`` proves on 4 virtual shards of one card (phases 5c and
8c); this script takes the same paths onto a mesh of every card (a power
of two of them, ``parallel.make_mesh()``), beside the virtual mesh, in one
process:

1. the committed fixture proved on the cards must equal its proof.json;
2. phase 5's 2^20 G1 MSM through ``ShardedRedMSM`` and
   ``make_sharded_msm`` on 4 virtual shards of card 0 and on the cards,
   each equal to the class-sum oracle, timed (best of two after a warm-up);
3. ``chip_smoke.phase_merkle``: the flagship, whose phase 8c proves once
   on 4 virtual shards and once on the cards, each equal to the 'red'
   proof and passing vk.verify.

Each card's name and power limit come first; the last line is
``{"ok": true, "cards": N}``.  It fails on one card or none.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from ethsnarks_tpu_torch.groth16 import ProverContext
from ethsnarks_tpu_torch.ops import _build, kernels, msm, msm_scan
from ethsnarks_tpu_torch.parallel import make_mesh
from ethsnarks_tpu_torch.parallel.msm_red_sharded import ShardedRedMSM
from ethsnarks_tpu_torch.parallel.msm_sharded import make_sharded_msm
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    witness_from_json


def fixture_on(mesh):
    pk = read_pk_binary(os.path.join(cs.FIXTURE, "pk.bin"), cs.DEV)
    ctx = ProverContext(pk, cs.fixture_cs(), mesh=mesh)
    proof = ctx.prove(witness_from_json(os.path.join(cs.FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(cs.FIXTURE, "proof.json")) as fh:
        if proof.to_json() != fh.read():
            cs.fail("the fixture proof on %s differs from proof.json" % mesh)
    cs.log("  the fixture on %s: equal to proof.json; phases %s" % (
        mesh, json.dumps({k: round(v, 4)
                          for k, v in ctx.last_profile.items()})))


def msm_on(meshes, points, words, want, reps=2):
    n = points.shape[0]
    c = msm.best_c(-(-n // 4))
    digits = msm.window_digits(words, c)
    for name, mesh in meshes:
        red = ShardedRedMSM(mesh, n, c)
        shards = red.shard_points(points)
        scan = make_sharded_msm(mesh, "g1", c)
        runs = (("red", lambda: red(shards, digits)),
                ("scan", lambda: msm_scan.to_host(scan(shards, digits),
                                                  False)))
        for kind, run in runs:
            times = []
            for _ in range(reps + 1):
                kernels.reset_counts()
                mesh.synchronize()
                t0 = time.perf_counter()
                got = run()
                mesh.synchronize()
                times.append(time.perf_counter() - t0)
                if got != want:
                    cs.fail("G1 MSM 2^%d on %s (%s) differs from the "
                            "oracle" % (cs.FULL_LOG, mesh, kind))
            cs.log("  G1 MSM 2^%d on %s, %s (c=%d): exact; times %s s; "
                   "min %.4f s = %.1f points/s; launches %s" % (
                       cs.FULL_LOG, name, kind, c,
                       [round(t, 4) for t in times], min(times[1:]),
                       n / min(times[1:]), json.dumps(
                           {k: v for k, v in cs.launch_counts().items()
                            if v})))
        del shards


def main():
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print("chip_mesh: needs two cards or more, found %d" % n_cards,
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.build()
    cards = make_mesh(1 << (n_cards.bit_length() - 1))
    virtual = make_mesh(devices=[cs.DEV] * 4)
    cs.log("== the fixture on %s" % cards)
    fixture_on(cards)
    cs.log("== phase 5's G1 MSM on %s and on %s" % (virtual, cards))
    _, inputs = cs.phase_msm(False, np.random.default_rng(cs.SEED), reps=1)
    msm_on((("virtual", virtual), ("cards", cards)), *inputs)
    del inputs
    torch.cuda.empty_cache()
    merkle = cs.phase_merkle()
    cs.log("  mesh results: %s" % json.dumps(merkle["mesh"], default=str))
    cs.log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "cards": len(cards)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
