"""Hunt for the rare non-finite loss of the float32 recipe
(``chip_smoke.py`` phase 11b: ``train_synthetic --profile ont
--train_compute_dtype float32``, the full-width model, 400 epochs at batch
256) in five steps, one subcommand each. Every result is printed and
written as JSON under ``--out`` (default ``build/recipe_nan/``).

    python3 tools/torch_recipe_nan.py kernels [--geometries FILE]
    python3 tools/torch_recipe_nan.py sanitize [--batches 16,32,41]
    python3 tools/torch_recipe_nan.py recipe --seeds 0-7 [--repeat 0] [--parallel 4]
    python3 tools/torch_recipe_nan.py replay SNAPSHOT

Poisoned memory (``chip_smoke.poisoned``): ``torch.use_deterministic_algorithms(True,
warn_only=True)`` with ``torch.utils.deterministic.fill_uninitialized_memory``,
so every ``torch.empty`` comes back filled: NaN in floating types, the
largest value in integer ones (a uint8 scratch's bf16 pieces read as
0xFFFF, a NaN). A kernel that reads bytes nobody wrote then gives NaN.
``CUBLAS_WORKSPACE_CONFIG`` is set to ``:4096:8`` before CUDA starts.

1. ``kernels``: in the poisoned mode, every kernel of the port (rows 1-6,
   both modes of rows 1 and 2) against its plain version at every geometry
   ``chip_smoke.py`` lists for it (FWD_GEOMETRIES, BWD_GEOMETRIES,
   RECIPE_GEOMETRIES, TRAIN_GEOMETRIES, PRECOMPUTED_GEOMETRIES,
   BILSTM2_BATCHES) and at the geometries a recipe run launched rows 1 and 2
   at (``--geometries``: a run's JSON from ``recipe``); a NaN in any output
   names the kernel, the geometry and the output.
3. (also ``kernels``) repeated launches: rows 1 and 2 in float32 at each of
   those recipe geometries, on fixed inputs from a seed, as many times as
   that run launched them there, still poisoned; every output must be bit
   for bit the first launch's, and finite.
2. ``sanitize``: compute-sanitizer's memcheck, initcheck (under
   ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, each ``torch.empty`` its own
   cudaMalloc), racecheck and synccheck over rows 1 and 2 in float32 at the
   recipe's smallest batches, both layers' widths; each tool's summary and
   exit code.
4. ``recipe``: the recipe through ``train_synthetic.main`` in a process of
   its own per seed, with ``np.random.seed(seed)`` first (the only draw the
   recipe does not seed is the bin's row order, ``data/bins.py:297``), in
   the poisoned mode, under a watch (``Watch``) that checks after every
   train and validation step each activation of the model, each gradient
   of an activation, each parameter's gradient before the clip, the global
   norm, each parameter after the update and the loss, and stops the run at
   the first non-finite one (naming the step, the tensor and its kind). Each
   run records every step's loss, its held-out recall, precision and exact
   matches against the recipe's floors, and the geometries and launches of
   rows 1 and 2. ``--repeat`` seeds run twice and their loss traces are
   compared bit for bit (the first step that differs is named).
   ``--scan``: the same runs with ``use_stream_bilstm=False`` (the JAX
   package's scan, no kernel); ``--plain``: neither poisoned nor watched,
   as chip_smoke.py runs the recipe (the host runs ahead of the card; a
   non-finite epoch sum names the epoch).
5. ``replay``: the snapshot a watched run saved at its first non-finite
   train step (the parameters, Adam's state, the dropout generator and the
   batch before the step) run again, with rows 1 and 2's inputs taken at
   each launch and replayed against their plain versions.

Needs a CUDA card and nvcc, except ``recipe --device cpu`` (a rehearsal at a
small size). Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CUBLAS_WORKSPACE = ":4096:8"
OUT = ROOT / "build" / "recipe_nan"
RECIPE = ["--profile", "ont", "--train_compute_dtype", "float32"]
# held-out floors of the recipe (chip_smoke.py phase 11b)
RECALL_FLOOR = PRECISION_FLOOR = 0.9
EXACT_SHARE = 0.85
SANITIZERS = ("memcheck", "initcheck", "racecheck", "synccheck")
# expm1's derivative exp(x) overflows float32 above this input, past
# log(FLT_MAX): a SELU that computes its negative branch on the whole input,
# as the JAX package's does, gets 0 * inf from the where's backward there, a
# NaN gradient (models/layers.py:selu takes expm1 of min(x, 0) and stays
# finite)
SELU_NAN_ABOVE = float(np.log(np.finfo(np.float32).max))
# the model's SELUs in the order a forward calls them (models/clair.py:
# _layers): l3, l4, then each head's l5 stem and the head
SELU_SITES = ("l3", "l4", "l5_1", "head_gt21", "l5_2", "head_genotype", "l5_3", "head_len1",
              "l5_4", "head_len2")
SANITIZE_TIMEOUT_S = 240


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def hex_floats(values) -> List[str]:
    return [float(v).hex() for v in values]


# ---- the watch (step 4) ---------------------------------------------------


class NonFinite(Exception):
    """A watched run's first non-finite tensor (Watch.first)."""


class _Activations(dict):
    """What ClairNet._layers records each layer's output into: every value
    checked as it is recorded, and its gradient when the backward reaches
    it."""

    def __init__(self, watch: "Watch"):
        super().__init__()
        self.watch = watch

    def __setitem__(self, name, value):
        self.watch.check("activation", name, value)
        if value.requires_grad:
            value.register_hook(lambda g, name=name: self.watch.check("activation gradient",
                                                                      name, g))


class Watch:
    """Checks every train and validation step of train_model for a
    non-finite tensor, in the order the step makes them: the model's
    activations (ClairNet._layers' names), the heads' logits, the gradients
    of the activations (backward order), each parameter's gradient before
    the clip, the global norm and each parameter after the update, then the
    loss. One host sync a step. It also keeps the largest input of each of
    the model's SELUs (SELU_SITES), train and validation steps apart: each
    epoch's, each site's and the run's peak (``selu``). ``install`` patches
    train_model's step factories (pipeline/train.py) and models/clair.py's
    selu for the run; nothing in the program changes. ``first`` is the
    first non-finite (step, epoch, kind, tensor); with ``stop`` the run then
    ends (NonFinite). ``snapshot_path``: each train step's inputs are kept
    (parameters, Adam's state, the dropout generator, the batch) and the
    failing step's are saved there. ``steps`` holds every step's (epoch,
    kind, loss bits)."""

    def __init__(self, stop: bool = True, snapshot_path: Optional[str] = None):
        self.stop = stop
        self.snapshot_path = snapshot_path
        self.steps: List[list] = []
        self.first: Optional[dict] = None
        self._flags: list = []
        self._epoch = 0
        self._last_kind = None
        self._state = None
        self._selu: list = []
        self.selu = {kind: {"epoch_max": [], "site_max": dict.fromkeys(SELU_SITES, -np.inf),
                            "peak": None} for kind in ("train", "validation")}
        self.model = self.optimizer = None

    def check(self, kind: str, name: str, t: torch.Tensor) -> None:
        self._flags.append(((kind, name), torch.isfinite(t.detach()).all()))

    def attach(self, model, optimizer=None) -> None:
        """Watch ``model``'s layers and ``optimizer``'s step (each once)."""
        if self.model is not model:
            self.model = model
            self._watch_layers(model)
        if optimizer is not None and self.optimizer is not optimizer:
            self.optimizer = optimizer
            self._watch_optimizer(optimizer)

    def _watch_layers(self, model) -> None:
        layers = model._layers

        def watched_layers(x, bilstm, dtype, generator=None, acts=None):
            out = layers(x, bilstm, dtype, generator, _Activations(self))
            for i, logits in enumerate(out):
                self.check("logits", f"head {i}", logits)
            return out

        model._layers = watched_layers

    def _watch_optimizer(self, optimizer) -> None:
        step = optimizer.step

        def watched_step(tensor_parallel=None):
            for name, p in zip(optimizer.names, optimizer.params):
                if p.grad is not None:
                    self.check("parameter gradient before the clip", name, p.grad)
            norm = step(tensor_parallel)
            self.check("global norm before the clip", "norm", norm)
            for name, p in zip(optimizer.names, optimizer.params):
                self.check("parameter after the update", name, p)
            return norm

        optimizer.step = watched_step

    def begin(self, kind: str, x, y, generator=None, l2_lambda=None) -> None:
        if kind == "train" and self._last_kind != "train":
            self._epoch += 1
        self._last_kind = kind
        self._flags = []
        self._selu = []
        if self.snapshot_path is not None and kind == "train":
            self._state = {
                "params": {n: p.detach().clone() for n, p in zip(self.optimizer.names,
                                                                   self.optimizer.params)},
                "adam": copy.deepcopy(self.optimizer.inner.state_dict()),
                "generator": generator.get_state(), "x": x.clone(), "y": y.clone(),
                "l2_lambda": l2_lambda, "step": len(self.steps), "epoch": self._epoch,
                "lr": self.optimizer.inner.param_groups[0]["lr"],
                "model_config": dataclasses.asdict(self.model.config)}

    def end(self, kind: str, loss: torch.Tensor) -> None:
        self.check("loss", kind, loss)
        flags = torch.stack([f for _, f in self._flags]).float()
        n_flags = len(self._flags)
        values = torch.cat([flags, *(m.float().reshape(1) for m in self._selu),
                            loss.detach().float().reshape(1)]).cpu()
        self.steps.append([self._epoch, kind, float(values[-1]).hex()])
        selu = self._selu_step(kind, values[n_flags:-1].tolist())
        bad = (values[:n_flags] == 0).nonzero()
        if len(bad) and self.first is None:
            (what, name), _ = self._flags[int(bad[0])]
            self.first = {"step": len(self.steps) - 1, "epoch": self._epoch, "phase": kind,
                          "kind": what, "tensor": name,
                          "non_finite_in_step": [" ".join(self._flags[int(i)][0])
                                                 for i in bad[:, 0]][:12],
                          "selu_input_max": selu}
            if self.snapshot_path is not None and self._state is not None and kind == "train":
                torch.save(_to_cpu(self._state), self.snapshot_path)
                self.first["snapshot"] = self.snapshot_path
            if self.stop:
                raise NonFinite(self.first)

    def _selu_step(self, kind: str, maxima) -> dict:
        """A step's largest SELU input by site (NaN where an input held
        one), folded into ``selu``."""
        step = {}
        for i, value in enumerate(maxima):
            site = SELU_SITES[i % len(SELU_SITES)]
            step[site] = float(np.fmax(step.get(site, -np.inf), value)) if not np.isnan(
                value) else value
        record = self.selu[kind]
        for site, value in step.items():
            record["site_max"][site] = float(np.fmax(record["site_max"][site], value))
        top = max(step.items(), key=lambda kv: kv[1]) if step else None
        if top is not None:
            if len(record["epoch_max"]) < self._epoch:
                record["epoch_max"].append(top[1])
            else:
                record["epoch_max"][self._epoch - 1] = max(record["epoch_max"][self._epoch - 1],
                                                          top[1])
            if record["peak"] is None or top[1] > record["peak"]["value"]:
                record["peak"] = {"value": top[1], "site": top[0], "step": len(self.steps) - 1,
                                  "epoch": self._epoch}
        return step

    @contextlib.contextmanager
    def install(self):
        """train_model's train and eval steps, and the model's SELUs,
        watched while inside."""
        import clair_tpu_torch.models.clair as clair
        import clair_tpu_torch.pipeline.train as train

        make_train, make_eval, selu = train.make_train_step, train.make_eval_step, clair.selu

        def watched_selu(x):
            self._selu.append(x.detach().amax())
            return selu(x)

        def make_train_step(model, optimizer, mesh=None):
            self.attach(model, optimizer)
            inner = make_train(model, optimizer, mesh)

            def step(x, y, generator, l2_lambda, sample_weights=None):
                self.begin("train", x, y, generator, l2_lambda)
                loss, components = inner(x, y, generator, l2_lambda, sample_weights)
                self.end("train", loss)
                return loss, components

            return step

        def make_eval_step(model, mesh=None):
            self.attach(model)
            inner = make_eval(model, mesh)

            def step(x, y, l2_lambda, sample_weights=None):
                self.begin("validation", x, y)
                loss, components = inner(x, y, l2_lambda, sample_weights)
                self.end("validation", loss)
                return loss, components

            return step

        train.make_train_step, train.make_eval_step = make_train_step, make_eval_step
        clair.selu = watched_selu
        try:
            yield self
        finally:
            train.make_train_step, train.make_eval_step = make_train, make_eval
            clair.selu = selu


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def first_difference(a: List[list], b: List[list]) -> Optional[dict]:
    """The first step whose loss differs bit for bit between two runs'
    ``Watch.steps`` (or where one run is longer), None if none does."""
    for i, (sa, sb) in enumerate(zip(a, b)):
        if sa != sb:
            return {"step": i, "epoch": sa[0], "phase": sa[1], "losses": [sa[2], sb[2]]}
    if len(a) != len(b):
        return {"step": min(len(a), len(b)), "lengths": [len(a), len(b)]}
    return None


# ---- rows 1 and 2's geometries in a run -----------------------------------


@contextlib.contextmanager
def recording_geometries(counts: collections.Counter):
    """Each launch of rows 1 and 2 (ops/bilstm_stream.py's _launch and
    _backward_launch) counted by geometry while inside:
    (row, dtype, B, T, F, H, with_cell or need_dx)."""
    from clair_tpu_torch.ops import bilstm_stream as stream

    launch, backward = stream._launch, stream._backward_launch

    def recorded_launch(x, w, u, b, *, with_cell, **kwargs):
        counts[(1, str(x.dtype)[6:], *x.shape, u.shape[1], bool(with_cell))] += 1
        return launch(x, w, u, b, with_cell=with_cell, **kwargs)

    def recorded_backward(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True, **kwargs):
        counts[(2, str(x.dtype)[6:], *x.shape, u.shape[1], bool(need_dx))] += 1
        return backward(x, w, u, b, h_out, c_out, dh_out, need_dx=need_dx, **kwargs)

    stream._launch, stream._backward_launch = recorded_launch, recorded_backward
    try:
        yield counts
    finally:
        stream._launch, stream._backward_launch = launch, backward


def geometry_rows(counts) -> List[dict]:
    return [{"row": k[0], "dtype": k[1], "batch": k[2], "t": k[3], "feat": k[4],
             "hidden": k[5], ("with_cell" if k[0] == 1 else "need_dx"): k[6], "launches": n}
            for k, n in sorted(counts.items())]


# ---- step 4: seeded recipe runs -------------------------------------------


def run_recipe(seed: int, epochs: int, device: str, out_dir: Path, scan: bool = False,
               recipe_args=(), plain: bool = False) -> dict:
    """One run of the recipe with numpy's global generator seeded first,
    poisoned and watched (or, ``plain``, as chip_smoke.py runs it: the
    host runs ahead of the card, and a non-finite epoch sum names the
    epoch); returns its record (see the module docstring, step 4)."""
    import chip_smoke as cs
    import clair_tpu_torch.pipeline.train as train
    from clair_tpu_torch.examples import train_synthetic
    from clair_tpu_torch.ops import launch_counts, reset_launch_counts

    tag = f"seed{seed}" + ("_scan" if scan else "")
    watch = Watch(snapshot_path=str(out_dir / f"{tag}_snapshot.pt"))
    counts: collections.Counter = collections.Counter()
    record = {"seed": seed, "epochs": epochs, "device": device, "scan": scan,
              "plain": plain, "recipe": RECIPE + list(recipe_args)}
    train_model = train.train_model

    def scan_train_model(dataset, config):
        return train_model(dataset, dataclasses.replace(config, use_stream_bilstm=False))

    np.random.seed(seed)
    reset_launch_counts()
    started = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if not plain:
            stack.enter_context(cs.poisoned())
            stack.enter_context(watch.install())
        stack.enter_context(recording_geometries(counts))
        if scan:
            train.train_model = scan_train_model
            stack.callback(setattr, train, "train_model", train_model)
        # the checkpoint is not kept
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="recipe_nan_"))
        try:
            out = train_synthetic.main(
                [*RECIPE, "--epochs", str(epochs), *recipe_args,
                 "--output", os.path.join(work, "model.ckpt")], device=device)
        except NonFinite:
            out = None
    record.update(wall_s=time.perf_counter() - started, nonfinite=watch.first,
                  launches=launch_counts(), geometries=geometry_rows(counts),
                  steps=watch.steps, selu=None if plain else watch.selu)
    if out is not None:
        result = out["result"]
        if plain:
            bad = [e for (t, e), (v, _) in zip(result.training_losses, result.validation_losses)
                   if not (np.isfinite(t) and np.isfinite(v))]
            record["nonfinite"] = {"epoch": bad[0], "epochs": len(bad)} if bad else None
        record.update(
            train_sums=hex_floats(v for v, _ in result.training_losses),
            val_sums=hex_floats(v for v, _ in result.validation_losses),
            first_val_sum=result.validation_losses[0][0],
            last_val_sum=result.validation_losses[-1][0],
            recall=out["recall"], precision=out["precision"], exact=out["exact"], n=out["n"],
            data_s=out["data_seconds"], train_s=out["train_seconds"],
            floors_met=bool(out["recall"] >= RECALL_FLOOR and out["precision"] >= PRECISION_FLOOR
                            and out["exact"] >= EXACT_SHARE * out["n"]))
    return record


def parse_seeds(text: str) -> List[int]:
    seeds = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            seeds.extend(range(int(lo), int(hi) + 1))
        elif part:
            seeds.append(int(part))
    return seeds


def cmd_recipe(args) -> int:
    """Step 4: each seed (and each --repeat seed once more) in a process of
    its own, --parallel at a time; a summary of the runs."""
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.device == "cuda":
        from clair_tpu_torch.ops import build

        for name in ("bilstm_stream_fwd", "bilstm_stream_bwd"):
            build.build(name)  # once, before the runs start
    runs = [(s, "") for s in parse_seeds(args.seeds)]
    runs += [(s, "_again") for s in parse_seeds(args.repeat)]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_WORKSPACE)

    def one(run):
        seed, suffix = run
        tag = f"seed{seed}" + ("_scan" if args.scan else "") + suffix
        cmd = [sys.executable, __file__, "recipe-one", "--seed", str(seed), "--epochs",
               str(args.epochs), "--device", args.device, "--out", str(out_dir),
               "--json", str(out_dir / f"{tag}.json"), *(["--scan"] if args.scan else []),
               *(["--plain"] if args.plain else []), "--recipe_args", args.recipe_args]
        with open(out_dir / f"{tag}.log", "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=ROOT).returncode
        path = out_dir / f"{tag}.json"
        record = json.loads(path.read_text()) if path.is_file() else None
        return tag, rc, record

    with ThreadPoolExecutor(max_workers=args.parallel) as pool:
        results = list(pool.map(one, runs))
    summary = {"card": card_line() if args.device == "cuda" else "cpu", "runs": []}
    records = {}
    for tag, rc, record in results:
        records[tag] = record
        if record is None:
            line = {"run": tag, "rc": rc, "error": "no record (see the log)"}
        else:
            selu = record.get("selu") or {}
            line = {"run": tag, "rc": rc, "nonfinite": record["nonfinite"],
                    "wall_s": round(record["wall_s"], 2),
                    **{f"selu_peak_{k}": v["peak"] for k, v in selu.items()},
                    **{k: record.get(k) for k in ("recall", "precision", "exact", "n",
                                                  "floors_met", "first_val_sum",
                                                  "last_val_sum", "train_s")}}
        summary["runs"].append(line)
        print(json.dumps(line), flush=True)
    for seed in parse_seeds(args.repeat):
        tag = f"seed{seed}" + ("_scan" if args.scan else "")
        a, b = records.get(tag), records.get(tag + "_again")
        if a is None or b is None:
            continue
        diff = first_difference(a["steps"], b["steps"])
        same = diff is None and a.get("train_sums") == b.get("train_sums") and \
            a.get("val_sums") == b.get("val_sums")
        summary.setdefault("repeats", []).append({"seed": seed, "bit_for_bit": same,
                                                  "first_difference": diff,
                                                  "steps": len(a["steps"])})
        print(f"seed {seed} twice: {'bit for bit the same' if same else 'DIFFERENT'} over "
              f"{len(a['steps'])} steps; first difference {diff}", flush=True)
    done = [r for r in records.values() if r is not None]
    nan_runs = [r["seed"] for r in done if r["nonfinite"] is not None]
    summary["counts"] = {"runs": len(results), "records": len(done), "nonfinite": len(nan_runs),
                         "nonfinite_seeds": nan_runs,
                         "floors_met": sum(bool(r.get("floors_met")) for r in done)}
    print(f"summary: {json.dumps(summary['counts'])} on {summary['card']}", flush=True)
    name = "recipe_scan_summary.json" if args.scan else "recipe_summary.json"
    (out_dir / name).write_text(json.dumps(summary, indent=1))
    ok = (len(done) == len(results) and not nan_runs
          and all(r.get("floors_met") for r in done)
          and all(rep["bit_for_bit"] for rep in summary.get("repeats", [])))
    return 0 if ok else 1


def cmd_recipe_one(args) -> int:
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, min(torch.get_num_threads(), 2)))
    record = run_recipe(args.seed, args.epochs, args.device, Path(args.out), args.scan,
                        args.recipe_args.split(), plain=args.plain)
    Path(args.json).write_text(json.dumps(record))
    print(json.dumps({k: v for k, v in record.items() if k not in ("steps",)}))
    return 0


# ---- steps 1 and 3: the kernels poisoned, and repeated launches -----------


def recipe_launches(path: Optional[str]) -> List[tuple]:
    """Rows 1 and 2's float32 launches in one recipe run (its JSON from
    ``recipe``), as chip_smoke.repeated_launches takes them: (row, B, F,
    with c or with dx, launches); none without a path."""
    if path is None:
        return []
    record = json.loads(Path(path).read_text())
    return [(g["row"], g["batch"], g["feat"], g.get("with_cell", g.get("need_dx")),
             g["launches"]) for g in record["geometries"] if g["dtype"] == "float32"]


def cmd_kernels(args) -> int:
    """Steps 1 and 3."""
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    with cs.poisoned():
        probe = {str(d)[6:]: torch.empty(2, dtype=d, device=dev).cpu().tolist()
                 for d in (torch.float32, torch.bfloat16, torch.uint8)}
    print(f"poisoned torch.empty on the card: {probe}", flush=True)
    launches = recipe_launches(args.geometries)
    extra = [(b, cs.T_LEN, f, cs.HIDDEN) for _, b, f, _, _ in launches]

    def shapes(*lists):
        return list(dict.fromkeys(g for group in (*lists, extra) for g in group))

    findings = cs.Findings()
    started = time.perf_counter()
    calls = cs.check_poisoned(
        dev, findings, fwd=shapes(cs.FWD_GEOMETRIES, cs.RECIPE_GEOMETRIES),
        bwd=shapes(cs.BWD_GEOMETRIES, cs.RECIPE_GEOMETRIES),
        train=shapes(cs.TRAIN_GEOMETRIES, cs.RECIPE_GEOMETRIES),
        precomputed=shapes(cs.PRECOMPUTED_GEOMETRIES, cs.RECIPE_GEOMETRIES),
        bilstm2=list(dict.fromkeys([*cs.BILSTM2_BATCHES, *(b for b, _, _, h in shapes(
            cs.RECIPE_GEOMETRIES) if h == cs.HIDDEN)])))
    print(f"step 1: {len(findings.lines)} outputs of {calls} kernel calls checked poisoned, "
          f"{len(findings.faults)} faults ({time.perf_counter() - started:.1f} s)", flush=True)
    repeats = cs.repeated_launches(dev, launches)
    bad = [r for r in repeats if not r["ok"]]
    print(f"step 3: {sum(r['launches'] for r in repeats)} launches at {len(repeats)} "
          f"geometries, {len(bad)} geometries with a differing or non-finite launch", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernels.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "poisoned_empty": probe,
         "geometries_from": args.geometries, "calls": calls, "step1": findings.lines,
         "step1_faults": findings.faults, "step3": repeats}, indent=1))
    print(f"card: {card}")
    return 0 if not findings.faults and not bad else 1


# ---- step 2: compute-sanitizer --------------------------------------------


def sanitizer_path() -> Optional[str]:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "compute-sanitizer"
    return str(candidate) if candidate.is_file() else shutil.which("compute-sanitizer")


def cmd_sanitize_one(args) -> int:
    """Rows 1 and 2 in float32 at each batch, both layers' widths, once
    each (the process compute-sanitizer runs)."""
    import chip_smoke as cs
    from clair_tpu_torch.ops import bilstm_stream as stream

    dev = torch.device("cuda")
    for batch in (int(b) for b in args.batches.split(",")):
        for feat in (32, 2 * cs.HIDDEN):
            rs = np.random.RandomState(batch + feat)
            params = cs.lstm_params(rs, feat, cs.HIDDEN, dev)
            x = torch.tensor(rs.randn(batch, cs.T_LEN, feat), dtype=torch.float32, device=dev)
            w, u, bias = stream._stack_params(params, torch.float32)
            h_out, c_out = stream._launch(x, w, u, bias, with_cell=True)
            dh = torch.tensor(rs.randn(batch, cs.T_LEN, 2 * cs.HIDDEN), dtype=torch.float32,
                              device=dev)
            got = stream._backward_launch(x, w, u, bias, h_out, c_out, dh,
                                          need_dx=feat != 32)
            torch.cuda.synchronize()
            finite = all(torch.isfinite(t).all().item() for t in (h_out, c_out, *got)
                         if t is not None)
            print(f"launched rows 1 and 2 float32 at ({batch}, {cs.T_LEN}, {feat}, "
                  f"{cs.HIDDEN}): finite {finite}", flush=True)
    return 0


def cmd_sanitize(args) -> int:
    """Step 2: each tool over one process that launches rows 1 and 2."""
    from clair_tpu_torch.ops import build

    sanitizer = sanitizer_path()
    card = card_line()
    for name in ("bilstm_stream_fwd", "bilstm_stream_bwd"):
        build.build(name)  # outside the sanitized process
    print(f"card: {card}; compute-sanitizer: {sanitizer}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = []
    for tool in args.tools.split(","):
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_WORKSPACE)
        if tool == "initcheck":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        cmd = [sanitizer, "--tool", tool, "--print-limit", "50",
               *(["--racecheck-report", "all"] if tool == "racecheck" else []),
               sys.executable, __file__, "sanitize-one", "--batches", args.batches]
        started = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                                  timeout=SANITIZE_TIMEOUT_S)
            rc, text = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            partial = e.stdout or b""
            rc = "timeout"
            text = partial.decode(errors="replace") if isinstance(partial, bytes) else partial
        except (OSError, TypeError) as e:
            rc, text = "did not start", str(e)
        (out / f"sanitize_{tool}.log").write_text(text)
        summary = [line for line in text.splitlines()
                   if "ERROR SUMMARY" in line or "RACECHECK SUMMARY" in line
                   or "launched rows" in line or "Error" in line][:20]
        results.append({"tool": tool, "rc": rc, "seconds": round(time.perf_counter() - started, 1),
                        "summary": summary, "tail": text[-1500:]})
        print(f"{tool}: rc {rc}, {results[-1]['seconds']} s", flush=True)
        for line in summary:
            print(f"  {line}", flush=True)
    (out / "sanitize.json").write_text(json.dumps({"card": card, "tools": results}, indent=1))
    print(f"card: {card}")
    return 0


# ---- step 5: replay a saved step ------------------------------------------


def cmd_replay(args) -> int:
    """The saved train step run again: rows 1 and 2's inputs at every
    launch replayed against their plain versions, and the step's first
    non-finite tensor, if any, named again."""
    from clair_tpu_torch.models.clair import ClairNet
    from clair_tpu_torch.ops import bilstm_stream as stream
    from clair_tpu_torch.params import ModelConfig
    from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    state = torch.load(args.snapshot, map_location="cpu", weights_only=False)
    config = ModelConfig(**state["model_config"])
    model = ClairNet(config, dev)
    model.load_state_dict(state["params"])
    optimizer = make_optimizer(dict(model.named_parameters()), config.optimizer_name,
                               state["lr"])
    optimizer.inner.load_state_dict(state["adam"])
    generator = torch.Generator(device=dev)
    generator.set_state(state["generator"])
    calls = []
    launch, backward = stream._launch, stream._backward_launch

    def kept_launch(x, w, u, b, *, with_cell, **kwargs):
        out = launch(x, w, u, b, with_cell=with_cell, **kwargs)
        calls.append(("row 1", (x, w, u, b), out))
        return out

    def kept_backward(x, w, u, b, h_out, c_out, dh_out, *, need_dx=True, **kwargs):
        out = backward(x, w, u, b, h_out, c_out, dh_out, need_dx=need_dx, **kwargs)
        calls.append(("row 2", (x, w, u, b, h_out, c_out, dh_out, need_dx), out))
        return out

    stream._launch, stream._backward_launch = kept_launch, kept_backward
    watch = Watch(stop=False)
    try:
        watch.attach(model, optimizer)
        step = make_train_step(model, optimizer)
        watch.begin("train", state["x"], state["y"])
        loss, _ = step(state["x"].to(dev), state["y"].to(dev), generator, state["l2_lambda"])
        watch.end("train", loss)
    finally:
        stream._launch, stream._backward_launch = launch, backward
    lines = []
    for kind, inputs, out in calls:
        if kind == "row 1":
            x, w, u, b = inputs
            want = stream.bilstm_stream_reference(stream._unstacked(w, u, b), x)
            pairs, extra = zip(("h", "c"), out, want), {}
        else:
            x, w, u, b, h_out, c_out, dh_out, need_dx = inputs
            want = stream.bilstm_stream_backward_reference(x, w, u, b, h_out, c_out, dh_out,
                                                           need_dx=need_dx)
            pairs = zip(("dx", "dw", "du", "db"), out, want)
            extra = {"inputs_finite": all(torch.isfinite(t).all().item()
                                          for t in (h_out, c_out, dh_out))}
        for name, g, r in pairs:
            if g is None or r is None:
                continue
            lines.append({"kernel": kind, "shape": list(x.shape), "output": name,
                          "non_finite": int((~torch.isfinite(g)).sum().item()),
                          "plain_non_finite": int((~torch.isfinite(r)).sum().item()),
                          "max_abs_err": (g.float() - r.float()).abs().max().item(), **extra})
            print(json.dumps(lines[-1]), flush=True)
    report = {"card": card, "snapshot": args.snapshot, "step": state["step"],
              "epoch": state["epoch"], "first_nonfinite": watch.first, "launches": lines}
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "replay.json").write_text(json.dumps(report, indent=1))
    print(f"replayed step {state['step']} (epoch {state['epoch']}): first non-finite "
          f"{watch.first}; {len(lines)} kernel outputs replayed; card: {card}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("kernels", help="steps 1 and 3")
    p.add_argument("--geometries", help="a recipe run's JSON (its rows 1 and 2 launches)")
    p = sub.add_parser("sanitize", help="step 2")
    p.add_argument("--batches", default="16,32,41")
    p.add_argument("--tools", default=",".join(SANITIZERS))
    p = sub.add_parser("sanitize-one", help="(the process step 2 sanitizes)")
    p.add_argument("--batches", default="16,32,41")
    for name in ("recipe", "recipe-one"):
        p = sub.add_parser(name, help="step 4" if name == "recipe" else "(one run of step 4)")
        p.add_argument("--epochs", type=int, default=400)
        p.add_argument("--device", default="cuda")
        p.add_argument("--scan", action="store_true", help="use_stream_bilstm=False")
        p.add_argument("--plain", action="store_true",
                       help="neither poisoned nor watched, as chip_smoke.py runs the recipe")
        p.add_argument("--recipe_args", default="",
                       help="more train_synthetic flags, one string (a smaller genome for "
                            "a rehearsal)")
        if name == "recipe":
            p.add_argument("--seeds", default="0-7")
            p.add_argument("--repeat", default="", help="seeds run twice")
            p.add_argument("--parallel", type=int, default=4)
        else:
            p.add_argument("--seed", type=int, required=True)
            p.add_argument("--json", required=True)
    p = sub.add_parser("replay", help="step 5")
    p.add_argument("snapshot")
    p.add_argument("--device", default="cuda")
    for p in sub.choices.values():
        p.add_argument("--out", default=str(OUT))
    args = parser.parse_args(argv)
    # before CUDA starts: cuBLAS's deterministic workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    return {"kernels": cmd_kernels, "sanitize": cmd_sanitize, "sanitize-one": cmd_sanitize_one,
            "recipe": cmd_recipe, "recipe-one": cmd_recipe_one, "replay": cmd_replay}[
        args.command](args)


if __name__ == "__main__":
    sys.exit(main())
