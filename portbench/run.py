"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control]

Loads the cell of ``BENCHMARK.json`` (its configuration file, its traffic
mix) and the configuration's model family (``family.py``: the module
``portbench/families/<family>.py``), draws the family's weights on the card
from the seed, starts the engine of ``lmdeploy_tpu_torch`` on them, warms
it up and brings the sessions in (set-up), measures ``--seconds`` seconds
of the mix's load, closes, checks what was served against the family's
plain reference, and prints one JSON line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``,
which traces the window's last seconds), each read by the file of its name
under ``portbench/metrics/``.  ``--control`` runs the check's control
instead (the mix's ``check.control``): the program on its own path one
precision lower (``engine`` knobs and, where given, the pool's
``kv_bits``), judged as any run is.  The comparison is the run's
``correct``.

Nothing here imports JAX or the JAX package; a run that finds either
loaded once the window has closed, the family's reference run, exits
with an error and no result.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()   # set-up counts from here, before any import

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(REPO))

# fixed cache directories inside the checkout; a library that would load
# JAX by itself is told not to
for _key, _val in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_key] = str(REPO / '.portbench_cache' / _val)
os.environ['USE_FLAX'] = '0'
os.environ['USE_TF'] = '0'

import family  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lmdeploy_tpu')


def forbidden_modules(names=None) -> list:
    """Loaded modules (``names``: those of ``sys.modules``) whose
    top-level name is JAX's, flax's or the JAX package's, compared
    whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def load_cell(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration and mix, and the metrics it
    reports (end-to-end, per-layer)."""
    cell = next((w for w in bench['workloads'] if w['name'] == workload),
                None)
    if cell is None:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    cfg = next(c for c in bench['configs'] if c['name'] == cell['config'])
    with open(REPO / cfg['file']) as f:
        config = json.load(f)
    tdir = REPO / bench['traffic_dir'] if 'traffic_dir' in bench \
        else HERE / 'traffic'
    with open(tdir / f"{cell['traffic']}.json") as f:
        mix = json.load(f)

    def has(m):
        return 'workloads' not in m or workload in m['workloads']
    e2e = [m for m in bench['end_to_end'] if has(m)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if workload in m.get('workloads', [])
                 or ('workloads' not in m and m['moves'] in e2e_names)]
    return dict(cell=cell, config=config, mix=mix, e2e=e2e,
                per_layer=per_layer)


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name}', HERE / 'metrics' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit_w():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


class Run:
    """What the window left, as the metric readers see it."""

    def __init__(self, bench, spec, fam, seconds, setup_s, summary):
        self.model = spec['config']['model']
        self.family = fam
        self.mix = spec['mix']
        self.seconds = seconds
        self.setup_s = setup_s
        self.t0, self.t1 = bench.t0, bench.t1
        self.window_s = bench.t1 - bench.t0
        # the window before the traced seconds, which the profiler slows
        traced_from = bench.trace.t_start if bench.trace is not None else None
        self.quiet_end = min(bench.t1, traced_from or bench.t1)
        self.records = list(bench.records)
        self.dispatches = list(bench.dispatches)
        self.stats0, self.stats1 = bench.stats0, bench.stats1
        self.host0, self.host1 = bench.host0, bench.host1
        self.pool_free = list(bench.pool_free)
        self.num_pages = bench.num_pages
        self.kv_bits = bench.kv_bits
        self.batch = bench.batch
        self.trace = summary

    def delta(self, key: str) -> float:
        return self.stats1.get(key, 0) - self.stats0.get(key, 0)

    def in_window(self, t) -> bool:
        return t is not None and self.t0 <= t < self.t1

    def in_quiet(self, t) -> bool:
        """``t`` inside the window and before any traced second."""
        return t is not None and self.t0 <= t < self.quiet_end


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help='cuda; cpu only for the tests\' dry runs')
    ap.add_argument('--benchmark', default=str(REPO / 'BENCHMARK.json'),
                    help='the benchmark file (the tests\' dry runs give '
                    'one of their own)')
    args = ap.parse_args(argv)

    with open(args.benchmark) as f:
        bench_json = json.load(f)
    spec = load_cell(bench_json, args.workload)
    chips = spec['cell']['chips']
    try:
        fam = family.load(spec['config'].get('family', family.DEFAULT),
                          REPO / bench_json['families_dir']
                          if 'families_dir' in bench_json else None)
    except LookupError as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 6

    import torch
    if args.device == 'cuda' and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f'portbench: the cell needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' available', file=sys.stderr)
        return 2
    import weights
    import check
    import tracing
    from serve import Bench
    from traffic import worst_case_pages

    model, mix = spec['config']['model'], spec['mix']
    logit_std = spec['config'].get('logit_std', weights.LOGIT_STD)
    dev = torch.device(args.device)
    # the pool's qparams as the configuration states them (the
    # reference's), and as the engine's pool stores them
    stated_kv = pool_kv = None
    if mix['engine'].get('quant_policy', 0) & 0x4:
        pool_kv, stated_kv = fam.kv_qparams(model, args.seed, 8)
    if args.control:
        ctl = mix['check']['control']
        mix = dict(mix, engine=dict(mix['engine'], **ctl['engine']))
        if 'kv_bits' in ctl:
            pool_kv = fam.kv_qparams(model, args.seed, ctl['kv_bits'])[0]

    raw = fam.make(model, args.seed, dev, logit_std)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    trace = None
    if args.trace:
        tmp = os.environ.get('TMPDIR', '/tmp')
        trace = tracing.TraceWindow(
            mix['trace_seconds'],
            os.path.join(tmp, f'portbench_trace_{os.getpid()}.json'))
        tracing.TraceWindow.warm_up(dev.type == 'cuda')
    params = fam.engine_params(raw)
    bench = Bench(model, mix, params, args.seed, dev, pool_kv, trace)
    del raw, params
    need = worst_case_pages(mix, bench.engine.ecfg.page_size,
                            bench.engine.ecfg.step_length)
    if bench.num_pages < need:
        bench.engine.shutdown()
        print(f'portbench: the pool holds {bench.num_pages} pages, the '
              f'mix needs {need} at worst', file=sys.stderr)
        return 3
    t_built = time.perf_counter()
    print(f'portbench: pool {bench.num_pages} pages, the mix needs {need} '
          f'at worst; engine built at {t_built - T_START:.2f} s',
          file=sys.stderr)
    bench.warm_up()
    t_warm = time.perf_counter()
    bench.open_window()
    print(f'portbench: warm-up {t_warm - t_built:.2f} s, ramp '
          f'{time.perf_counter() - t_warm:.2f} s', file=sys.stderr)
    bench.window(args.seconds)
    setup_s = bench.t0 - T_START
    bench.drain(mix.get('drain', 'cancel'))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    rule = mix['check']
    chosen = check.sample(bench.records, rule, args.seed)
    program_argmax = bench.prompt_argmax(chosen) \
        if rule.get('every_position') else None
    bench.stop()
    if bench.engine.alive():
        print('portbench: the engine did not stop', file=sys.stderr)
        return 4
    summary = None
    if trace is not None:
        t_exp = time.perf_counter()
        data = trace.export()
        summary = tracing.reduce(data, fam.KERNEL_CLASSES) if data \
            else None
        print(f'portbench: trace of {len((data or {}).get("traceEvents", []))}'
              f' events read in {time.perf_counter() - t_exp:.2f} s',
              file=sys.stderr)
        del data
    run = Run(bench, spec, fam, args.seconds, setup_s, summary)
    bench.free()
    del bench
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    statuses: dict = {}
    for r in run.records:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    print(f'portbench: request statuses {statuses} (None: cut at the '
          f'close); engine stats {run.stats1}', file=sys.stderr)
    attempted = sum(1 for r in run.records if run.in_window(r.t_send))
    failed = sum(1 for r in run.records
                 if r.status not in (None, 1)
                 and (r.t_end is None or r.t_end < run.t1
                      or mix.get('drain') == 'wait'))
    metrics = {}
    for m in (spec['per_layer'] if args.trace else spec['e2e']):
        value = reader(m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    # the check, once the program's state is gone
    raw = fam.make(model, args.seed, dev, logit_std)
    t_ref = time.perf_counter()
    numbers = check.compare(
        raw, model, mix, chosen,
        stated_kv if rule.get('reference_kv') == 'pool' else None,
        program_argmax, forward=fam.forward) if chosen else {'requests': 0.0}
    numbers['reference_s'] = time.perf_counter() - t_ref
    del raw
    lim = check.limits(args.workload, REPO / bench_json['limits_dir']
                       if 'limits_dir' in bench_json else check.LIMITS)
    judged = check.judge(numbers, lim)
    correct = bool(chosen) and check.passed(judged)
    for k, v in numbers.items():
        print(f'portbench: check {k} = {v!r}', file=sys.stderr)
    for k, v in judged.items():
        print(f"check: {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)

    device = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
              'kind': torch.cuda.get_device_name(dev)
              if dev.type == 'cuda' else 'cpu',
              'count': chips, 'memory_peak_bytes': int(peak),
              'power_limit_w': power_limit_w() if dev.type == 'cuda'
              else None}
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': device}
    if args.trace and summary is not None:
        device['busy_s'] = summary['busy_s']
        device['window_s'] = summary['window_s']
        result['breakdown'] = tracing.breakdown(summary)
    result['check'] = judged
    found = forbidden_modules()
    if found:
        print(f'portbench: loaded after the window: {found}',
              file=sys.stderr)
        return 5
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
