"""One run of one cell: set-up, the measured window, the check, the
result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program's circuit, makes the requests from the seed
(:mod:`.traffic.generate`), fills the assignment where the cell proves one
assignment again and again (entry ``prove``), reads the proving key from
``port_bench/.cache/<config>/`` (on a checkout's first run it makes it
with the program's ``generator`` from the configuration's key seed and
writes it there with the program's own ``write_pk_binary``), builds one
``ProverContext`` and warms it up with one request.  The window is a
closed loop of one client: each request is the full assignment handed to
``ProverContext.prove`` (entry ``prove``) or a fresh batch through the
circuit's ``set_witness`` and then ``prove`` (entry ``fill_prove``), until
``--seconds`` have passed; the last request started runs to its end.  With
``--trace 1`` the window runs under ``torch.profiler``
(:mod:`.devtrace`).  After the window the peak device memory is read, the
program's state freed, and :mod:`.compare` holds a sample of the answers
to the plain reference.
"""

import gc
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext

from . import compare, devtrace, spec
from .record import CircuitStats, Run
from .traffic import generate

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ethsnarks_tpu')
CACHE = os.path.join(spec.HERE, '.cache')


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN})


def keypair(cell, cs, device, cache=CACHE):
    """(proving key, QAP or None): read from the cache, or made with the
    program's generator and written there first."""
    from ethsnarks_tpu_torch import serialization
    from ethsnarks_tpu_torch.groth16 import generator
    cfg = cell.config
    if cfg['mode'] != 'nozk':
        raise ValueError("mode %r: the harness proves nozk" % cfg['mode'])
    where = os.path.join(cache, cfg['name'])
    ident = {'args': cfg['args'], 'key_seed': cfg['key_seed'],
             'mode': cfg['mode'], 'circuit': cfg['circuit']}
    pk_path = os.path.join(where, 'pk.bin')
    id_path = os.path.join(where, 'key.json')
    try:
        with open(id_path) as fh:
            hit = json.load(fh) == ident and os.path.exists(pk_path)
    except (OSError, ValueError):
        hit = False
    if hit:
        t = time.perf_counter()
        pk = serialization.read_pk_binary(pk_path, device=device)
        log("key: read %s in %.3f s" % (pk_path, time.perf_counter() - t))
        return pk, None
    t = time.perf_counter()
    kp = generator(cs, rng=generate.key_rng(cfg['key_seed']), device=device)
    log("key: made in %.3f s (%s)" % (time.perf_counter() - t, kp.profile))
    os.makedirs(where, exist_ok=True)
    tmp = pk_path + '.part'
    serialization.write_pk_binary(kp.pk, tmp)
    os.replace(tmp, pk_path)
    serialization.vk2json_file(kp.vk, os.path.join(where, 'vk.json'))
    with open(id_path, 'w') as fh:
        json.dump(ident, fh)
    return kp.pk, kp.qap


def _phases(requests):
    """(label, start, end) host intervals of each request: the harness's
    fill, the call into prove before the program's first mark, and the
    program's spans placed back from the call's end."""
    out = []
    for r in requests:
        if r.get('failed'):
            continue
        t = r['start']
        if 'filled' in r:
            out.append(('set_witness', t, r['filled']))
            t = r['filled']
        # the spans follow one another in the order of the program's marks
        at = r['end'] - sum(r['profile'].values())
        out.append(('prove.call', t, at))
        for k, v in r['profile'].items():
            out.append(('prove.' + k, at, at + v))
            at += v
    return out


def run(cell, seed, seconds, trace, device, t0, cache=CACHE):
    """One run -> the result dict (without the device's name)."""
    import torch
    from ethsnarks_tpu_torch.groth16 import ProverContext
    from ethsnarks_tpu_torch.ops import kernels
    device = torch.device(device)
    entry = cell.spec['entry']
    if entry not in ('prove', 'fill_prove'):
        raise ValueError("entry %r: 'prove' or 'fill_prove'" % entry)
    args = cell.config['args']
    inputs = generate.make(cell.traffic, seed)
    pool = inputs['pool']

    t = time.perf_counter()
    model = cell.program.build(args, device)
    cs = model.pb
    log("build: %d constraints, %d variables in %.3f s"
        % (cs.num_constraints, cs.num_variables, time.perf_counter() - t))
    want = cell.reference.shape(args)
    got = dict(constraints=cs.num_constraints, inputs=cs.num_inputs,
               variables=cs.num_variables)
    if got != want:
        raise RuntimeError("circuit shape %s, the reference's %s"
                           % (got, want))
    witness_setup = None
    if entry == 'prove':
        t = time.perf_counter()
        info = cell.program.fill(model, pool[0])
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        witness_setup = time.perf_counter() - t
        log("set-up witness: %.3f s %s" % (witness_setup, info))
    pk, qap = keypair(cell, cs, device, cache)
    t = time.perf_counter()
    ctx = ProverContext(pk, cs, device=device, qap=qap)
    log("context: %.3f s (m = %d)" % (time.perf_counter() - t,
                                      ctx.qap.domain_size))
    t = time.perf_counter()
    if entry == 'fill_prove':
        cell.program.fill(model, inputs['warmup'])
    ctx.prove(cs.values)
    log("warm-up request: %.3f s %s" % (time.perf_counter() - t,
                                        ctx.last_profile))
    del inputs['warmup']
    gc.collect()
    kernels.reset_counts()
    setup_s = time.perf_counter() - t0

    tr = devtrace.Trace() if trace else None
    requests = []
    with tr.window() if tr else nullcontext():
        w0 = time.perf_counter()
        deadline = w0 + seconds
        i = 0
        while True:
            req = pool[i % len(pool)]
            rec = {'request': req, 'start': time.perf_counter()}
            try:
                if entry == 'fill_prove':
                    cell.program.fill(model, req)
                    rec['filled'] = time.perf_counter()
                rec['proof'] = ctx.prove(cs.values)
                rec['end'] = time.perf_counter()
                rec['profile'] = dict(ctx.last_profile)
                if entry == 'fill_prove':
                    rec['values'] = list(cs.values)
            except Exception:
                rec['end'] = time.perf_counter()
                rec['failed'] = True
                log("request %d failed:\n%s" % (i, traceback.format_exc()))
            requests.append(rec)
            i += 1
            if rec['end'] >= deadline:
                break
        window_s = requests[-1]['end'] - w0
    launches = {k.name: k.launches for k in kernels.ALL if k.launches}
    log("window: %d requests in %.3f s; kernel launches %s"
        % (len(requests), window_s, launches))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    setup_values = None if entry == 'fill_prove' else list(cs.values)
    summary = stats = None
    if tr:
        t = time.perf_counter()
        summary = tr.summary(_phases(requests))
        stats = CircuitStats(cs, ctx.qap.domain_size)
        log("trace: read in %.3f s, busy %.3f s of %.3f s"
            % (time.perf_counter() - t, summary['busy_s'],
               summary['window_s']))
    rec = Run(setup_s, window_s, requests, witness_setup, summary, stats,
              lambda r: r.get('values', setup_values))
    metrics = {}
    t = time.perf_counter()
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m)(rec)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    log("metrics: read in %.3f s" % (time.perf_counter() - t))
    del ctx, pk, qap, model, cs, tr, rec
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    t = time.perf_counter()
    done = [r for r in requests if not r.get('failed')]
    if entry == 'prove':
        picked = done
    else:
        picked = [done[j] for j in compare.sample(
            len(done), cell.spec['check_sample'], seed)]
    answers = [(r['request'], compare.proof_ints(r['proof']),
                r.get('values', setup_values if j == 0 else None))
               for j, r in enumerate(picked)]
    numbers, info = compare.check(cell, answers, seed)
    log("check: %.3f s %s" % (time.perf_counter() - t, info))
    failed = len(requests) - len(done)
    correct = failed == 0 and bool(done) and all(
        numbers[k] <= compare.LIMITS[k] for k in numbers)
    out = {'correct': correct, 'attempted': len(requests),
           'failed': failed, 'metrics': metrics,
           'device': {'memory_peak_bytes': int(peak)}}
    if summary is not None:
        out['device'].update(busy_s=summary['busy_s'],
                             window_s=summary['window_s'])
        if summary['busy_s'] > 0:
            out['breakdown'] = {'device_ops': summary['device_ops'],
                                'idle_gaps': summary['idle_gaps']}
        else:
            log("trace: no device activity in the profiler's trace; "
                "idle_share and breakdown not measured")
    out['checks'] = {k: {'value': v, 'limit': compare.LIMITS[k]}
                     for k, v in numbers.items()}
    return out


def card():
    """(name, power limit as nvidia-smi reads it)."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = 'not read'
    return name, limit


def main(argv, t0):
    import argparse
    ap = argparse.ArgumentParser(prog='port_bench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log("no CUDA card, or fewer than the %d the cell asks for: "
            "nothing is measured" % cell.chips)
        return 2
    name, limit = card()
    log("card: %s, power limit %s" % (name, limit))
    out = run(cell, a.seed, a.seconds, a.trace, 'cuda', t0)
    out['device'] = dict(platform='gpu', kind=name, count=cell.chips,
                         **out['device'])
    bad = forbidden_modules()
    if bad:
        log("refused: the process loaded %s" % ", ".join(bad))
        return 3
    checks = out.pop('checks')
    out['power_limit'] = limit
    out['checks'] = checks
    for k, v in checks.items():
        log("check %s %s limit %s" % (k, v['value'], v['limit']))
    print(json.dumps(out), flush=True)
    return 0
