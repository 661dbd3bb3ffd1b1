"""One run of a cell: set-up, the timed window, the reference.

Set-up builds the program's training step
(``repro_torch.launch.steps.make_lgc_train_step``) for the cell's
configuration and traffic, with K nodes emulated on the one device,
hands it the weights drawn from the seed and the batches of the
traffic's Markov chain staged on the device, and drives that same object
through ``setup_steps`` steps, as the trainer's loop does (the loss read
back once a step).  The first ``check.COMPARED_STEPS`` of them are what
the reference follows; the rest warm up the cell's own phase.  Step
numbers start at the traffic's ``first_step``, so the learning-rate
schedule and the phases are those of a job at that step.  The window
then calls the same step back to back for ``seconds``, each step on the
pool's next batch.  Once it has closed and the peak memory is read, the
program's state is freed and the reference runs the compared steps
again from the seed."""
from __future__ import annotations

import gc
import importlib
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from lgcbench import check, data, manifest, spans as S, trace as T, weights
from lgcref import common, lgc


@dataclass
class Cell:
    name: str
    cfg: Dict
    traffic: Dict
    limits: Dict

    @property
    def family(self):
        return importlib.import_module(f"lgcref.{self.cfg['family']}")

    @property
    def adapter(self):
        return importlib.import_module(
            f"lgcbench.families.{self.cfg['family']}")

    @property
    def spec(self):
        return self.family.params_spec(self.cfg)

    @property
    def K(self) -> int:
        return self.traffic["nodes"]

    @property
    def rows(self) -> int:
        return self.traffic["nodes"] * self.traffic["rows_per_node"]

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.traffic["seq_len"]

    def phase(self, step: int) -> str:
        t = self.traffic
        return lgc.phase(t["method"], step, t["warmup_steps"],
                         t["ae_train_steps"])

    def comp(self) -> Dict:
        return dict(self.cfg["compression"], method=self.traffic["method"],
                    transport=self.traffic["transport"])


def load_cell(name: str, cfg_over: Optional[Dict] = None,
              traffic_over: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json; the overrides shrink it for
    the CPU tests."""
    w = manifest.workload(name)
    cfg = dict(manifest.config(w["config"]), **(cfg_over or {}))
    traffic = dict(manifest.traffic(w["traffic"]), **(traffic_over or {}))
    return Cell(name, cfg, traffic, manifest.limits(name))


def batches(cell: Cell, seed: int, device, n: int):
    t = cell.traffic
    return [{k: torch.from_numpy(x).to(device) for k, x in b.items()}
            for b in data.pool(cell.cfg["vocab_size"], cell.rows,
                               t["seq_len"], seed, n)]


def _norm_change(now: torch.Tensor, start: torch.Tensor) -> float:
    """||now - start|| in float32, a bounded slice at a time."""
    a, b = now.reshape(-1), start.reshape(-1)
    step = 1 << 26
    return math.sqrt(sum(
        float(((a[i:i + step].float() - b[i:i + step].float()) ** 2).sum())
        for i in range(0, a.numel(), step)))


# ---------------------------------------------------------------------------
# the program


class Program:
    """The system under test as the cell drives it."""

    def __init__(self, cell: Cell, seed: int, device,
                 patch: Optional[Callable] = None):
        from repro_torch.configs.base import CompressionConfig, TrainConfig
        from repro_torch.launch.steps import make_lgc_train_step
        from repro_torch.models.model import build_model
        from repro_torch.utils import deterministic_convs, disable_tf32

        disable_tf32()
        deterministic_convs()
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t, c, tr = cell.traffic, cell.cfg["compression"], cell.cfg["train"]
        cc = CompressionConfig(
            method=t["method"], sparsity=c["sparsity"],
            warmup_steps=t["warmup_steps"],
            ae_train_steps=t["ae_train_steps"], ae_lr=c["ae_lr"],
            momentum_correction=c["momentum_correction"],
            transport=t["transport"], topk_backend=t["topk_backend"],
            ae_backend=t["ae_backend"])
        tc = TrainConfig(
            optimizer=tr["optimizer"], learning_rate=tr["learning_rate"],
            weight_decay=tr["weight_decay"], adam_b1=tr["adam_b1"],
            adam_b2=tr["adam_b2"], grad_clip_norm=tr["grad_clip_norm"],
            steps=tr["total_steps"], compression=cc)
        model = build_model(cell.adapter.port_config(cell.cfg))
        K = cell.K
        self.lts = make_lgc_train_step(model, tc, K, self.device, (K,))
        w = weights.draw(cell.spec, seed, self.device)
        _same_tree(weights.flatten(model.init(torch.Generator(), "meta")),
                   w)
        self.params = weights.nest(w)
        del w
        self.opt_state = self.lts.optimizer.init(self.params)
        self.comp_state = self.lts.compressor.init_sim_states(
            torch.Generator(device=self.device).manual_seed(0), self.device)
        if "ae" in self.comp_state:
            ae = weights.draw_ae(seed, self.device)
            for path, x in weights.flatten(self.comp_state["ae"]).items():
                x.copy_(ae[path])
        self.batches = batches(cell, seed, self.device,
                               cell.traffic["pool_batches"])
        self.step_no = cell.traffic["first_step"]
        self.calls = 0
        if patch is not None:
            patch(self.lts)

    def step(self):
        """The next step on the pool's next batch: (loss, metrics)."""
        s = self.step_no
        batch = self.batches[self.calls % len(self.batches)]
        self.params, self.opt_state, self.comp_state, metrics = \
            self.lts.step(self.params, self.opt_state, self.comp_state,
                          batch, s, self.cell.phase(s))
        loss = float(metrics["loss"])            # waits for the device
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_no += 1
        self.calls += 1
        return loss, metrics

    def grad_norms(self) -> Dict[str, float]:
        b1 = self.cell.cfg["train"]["adam_b1"]
        return {p: float(torch.linalg.vector_norm(m)) / (1 - b1)
                for p, m in weights.flatten(self.opt_state["m"]).items()}

    def change_norms(self) -> Dict[str, float]:
        now = weights.flatten(self.params)
        out = {}
        for i, e in enumerate(self.cell.spec):
            start = weights.draw_leaf(e, self.seed, i, self.device)
            out[e[0]] = _norm_change(now[e[0]], start)
            del start
        return out


def _same_tree(template: Dict, drawn: Dict) -> None:
    """The drawn weights have the program's paths, shapes and dtypes."""
    want = {p: (tuple(x.shape), x.dtype) for p, x in template.items()}
    got = {p: (tuple(x.shape), x.dtype) for p, x in drawn.items()}
    if want != got:
        raise RuntimeError(f"the configuration's weights differ from the "
                           f"program's: program {want}, drawn {got}")


def setup(cell: Cell, seed: int, device, patch=None):
    """The program after its set-up steps, and its readings of the
    compared steps."""
    t0 = time.perf_counter()
    prog = Program(cell, seed, device, patch)
    prog.setup_s = {"program": time.perf_counter() - t0, "steps": []}
    losses, grad, change = [], None, None
    for j in range(cell.traffic["setup_steps"]):
        ts = time.perf_counter()
        loss, _ = prog.step()
        prog.setup_s["steps"].append(time.perf_counter() - ts)
        if j < check.COMPARED_STEPS:
            losses.append(loss)
        if j == 0:
            grad = prog.grad_norms()
        if j == check.COMPARED_STEPS - 1:
            change = prog.change_norms()
    phase = cell.phase(prog.step_no)
    if phase != cell.traffic["phase"]:
        raise RuntimeError(f"the window would run phase {phase!r}, the cell "
                           f"names {cell.traffic['phase']!r}")
    return prog, {"losses": losses, "grad": grad, "change": change}


# ---------------------------------------------------------------------------
# the window


@dataclass
class Window:
    step_ms: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    seconds: float = 0.0
    wire: Dict = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[Dict] = None
    trace_steps: int = 0


def window(prog: Program, seconds: float, traced: bool,
           span_targets: Dict[str, str]) -> Window:
    w = Window()
    spans = None
    if traced:
        spans = S.Spans(prog.device)
        for name, target in span_targets.items():
            spans.wrap(prog.lts, target, name)
        spans.live = True
    limit = prog.cell.traffic.get("trace_steps") or 0
    prof = T.start() if traced else None
    t0 = time.perf_counter()
    paused = 0.0        # reducing a trace that stops early: not the window's
    while True:
        ts = time.perf_counter()
        loss, metrics = prog.step()
        now = time.perf_counter()
        w.step_ms.append((now - ts) * 1e3)
        w.losses.append(loss)
        if prof is not None and len(w.step_ms) == limit:
            w.trace = {"prof": prof, "seconds": now - t0 - paused}
            w.trace_steps = limit
            prof.stop()
            prof = None
            paused += time.perf_counter() - now
        if time.perf_counter() - t0 - paused >= seconds:
            break
    w.seconds = time.perf_counter() - t0 - paused
    if prof is not None:
        prof.stop()
        w.trace = {"prof": prof, "seconds": w.seconds}
        w.trace_steps = len(w.step_ms)
    w.wire = metrics.get("wire", {})
    if spans is not None:
        spans.live = False
        w.spans = spans.ms()
    if w.trace is not None:
        w.trace = T.summary(w.trace["prof"], w.trace["seconds"])
    return w


# ---------------------------------------------------------------------------
# the reference


def reference_readings(cell: Cell, seed: int, device, mm=common.f32_mm,
                       fault: Optional[str] = None) -> Dict:
    """The reference's readings of the compared steps (with ``mm`` the
    control's matmul, with ``fault`` a broken step)."""
    ref = lgc.Reference(cell.family, cell.cfg, cell.cfg["train"],
                        cell.comp(), cell.K, device, mm, fault)
    w0 = weights.draw(cell.spec, seed, device)
    ae = weights.draw_ae(seed, device) \
        if cell.traffic["method"].startswith("lgc") else None
    ref.init(w0, ae)
    del ae
    bs = batches(cell, seed, device, check.COMPARED_STEPS)
    losses, grad = [], None
    s = cell.traffic["first_step"]
    for j, b in enumerate(bs):
        losses.append(ref.step(b["tokens"], b["labels"], s + j,
                               cell.phase(s + j)))
        if j == 0:
            grad = ref.grad_norms()
    change = {p: _norm_change(ref.params[p], w0[p]) for p in w0}
    return {"losses": losses, "grad": grad, "change": change}


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

