"""The one-call deployment driver: ``repro_torch.compile(net, target)``.

Counterpart of :mod:`repro.compile.driver`.  :func:`compile` runs the
reference's pass pipeline over a :class:`Target` descriptor, in plain
Python, numpy and PyTorch on the host, with no JAX:

  ``build``     resolve the net (Graph or registered name) and validate,
  ``schedule``  operator reordering (branch-and-bound over topo orders),
  ``plan``      solve ONE segment ring for the whole net (Eq. 1/2),
  ``budget``    gate the byte-granular bottleneck on the target's SRAM
                (before the expensive passes, so an over-budget net
                fails in milliseconds),
  ``partial``   slice over-budget fusion groups spatially until the
                deployable ring fits (``partial="auto"|N``,
                :mod:`repro_torch.partial`),
  ``quantize``  int8 calibration + requant tables (int8 targets),
  ``lint``      budget/consistency findings (VMCU3xx/4xx — errors
                abort, warnings ride in the note),
  ``certify``   prove the plan clobber-free: replay it through the
                SegmentPool sim oracle (``"sim"``), or prove it
                statically (``"static"``, :mod:`repro_torch.analysis
                .verifier`; outside the verifier's decidable fragment
                the pass falls back to the sim oracle and says so).

Every plan, certificate, ``mcu`` summary and emitted C unit
(:meth:`CompiledNet.emit_c`) it writes is the reference's, byte for
byte, sliced plans (``partial``) and the lint pass's VMCU303 estimate
of partial execution included.

The result is a :class:`CompiledNet`, which is also what :func:`load`
returns for a saved plan artifact (loading never re-runs the planner,
and checks that the stored program is the one its certificate proved
safe, VMCU403).  A float plan carries its fp32 ``params`` (drawn on
first need when the compile was given none); an int8 plan carries its
calibrated ``qnet``.  A float artifact saved without its params runs
only with params the caller supplies, through
:meth:`CompiledNet.from_payload` —
``repro_torch.kernels.cases.seeded_float_net`` builds them from a numpy
seed.  ``CompiledNet.run`` runs either on the CUDA card unless the
caller passes ``device="cpu"``; without a card it raises rather than
run elsewhere; ``run(x, trace=True)`` and :meth:`CompiledNet.profile`
return a :class:`repro_torch.obs.TraceArtifact` of the run beside it.
``CompiledNet.stream`` opens a
:class:`repro_torch.stream.StreamSession` on a streaming plan, int8 or
float, on the same terms.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.codegen import emit_program
from ..core.program import PoolProgram, dtype_itemsize
from ..graph.ir import (Graph, build_ad_autoencoder, build_ds_cnn,
                        build_mcunet, build_mobilenet_v1, build_resnet8)
from ..graph.netplan import NetPlan, _plan_net
from ..graph.run import (QuantizedNet, _quantize_net, certify_net,
                         init_net_params, run_net, run_net_quantized)
from ..graph.schedule import reorder
from ..obs.spans import SpanCollector, collect, span
from . import artifact
from .targets import Target, get_target

PASS_NAMES = ("build", "schedule", "plan", "budget", "partial",
              "quantize", "lint", "certify")

_UNSET = object()


class CompileError(Exception):
    """A pass of the compile pipeline failed, or a compiled net is
    unusable (e.g. its plan changed after it was certified)."""


class SRAMBudgetError(CompileError):
    """The planned net does not fit the target's SRAM budget."""


# ---------------------------------------------------------------------------
# Net registry — the names ``compile`` takes.
# ---------------------------------------------------------------------------

def _vww() -> Graph:
    from ..core.graph_planner import MCUNET_5FPS_VWW

    return build_mcunet(MCUNET_5FPS_VWW, "mcunet-5fps-vww", num_classes=2)


def _imagenet() -> Graph:
    from ..core.graph_planner import MCUNET_320KB_IMAGENET

    return build_mcunet(MCUNET_320KB_IMAGENET, "mcunet-320kb-imagenet",
                        num_classes=1000)


def _ds_cnn_stream() -> Graph:
    from ..stream import to_streaming

    return to_streaming(build_ds_cnn())


# MLPerf-Tiny-class model zoo, the reference's: real k x k spatial convs
# through the same one-ring planner as the MCUNet tables, plus the
# FC-heavy ToyADMOS autoencoder and the per-frame streaming DS-CNN.
_NET_BUILDERS = {"mcunet-5fps-vww": _vww, "mcunet-320kb-imagenet": _imagenet,
                 "ds-cnn": build_ds_cnn, "resnet-8": build_resnet8,
                 "mobilenetv1-0.25": build_mobilenet_v1,
                 "ad-toyadmos": build_ad_autoencoder,
                 "ds-cnn-stream": _ds_cnn_stream}
_NET_ALIASES = {"mcunet-vww": "mcunet-5fps-vww",
                "mcunet-imagenet": "mcunet-320kb-imagenet",
                "dscnn": "ds-cnn", "resnet8": "resnet-8",
                "mobilenet-v1": "mobilenetv1-0.25",
                "toyadmos": "ad-toyadmos", "ad-ae": "ad-toyadmos",
                "dscnn-stream": "ds-cnn-stream"}


def available_nets() -> tuple[str, ...]:
    return tuple(sorted(_NET_BUILDERS))


def _resolve_net(net) -> Graph:
    if isinstance(net, Graph):
        return net
    if isinstance(net, str):
        name = _NET_ALIASES.get(net, net)
        try:
            return _NET_BUILDERS[name]()
        except KeyError:
            raise ValueError(f"unknown net {net!r}; known: "
                             f"{available_nets()}") from None
    raise TypeError(f"net must be a Graph or a registered name, got "
                    f"{type(net).__name__}")


@dataclasses.dataclass(frozen=True)
class PassRecord:
    name: str
    seconds: float
    note: str = ""


def _nbytes(obj) -> int:
    """Total array bytes in a params or qparams structure."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return 0
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return obj.nbytes


def _flash_param_bytes(program: PoolProgram,
                       parents: list[int] | None = None) -> int:
    """Analytic float-parameter storage (4 B/element, the init_net_params
    shapes) — lets ``report()`` account flash without materializing
    parameters on planner-only compiles.  ``parents`` (sliced programs)
    counts each unsliced op's parameters once across its slices."""
    total = 0
    seen: set[int] = set()
    for i, op in enumerate(program.ops):
        if parents is not None:
            if parents[i] in seen:
                continue
            seen.add(parents[i])
        if op.kind in ("gemm", "conv_pw"):
            total += op.d_in * op.d_out
        elif op.kind in ("conv_k2d", "conv_stream"):
            total += op.rs * op.rs * op.d_in * op.d_out
        elif op.kind == "gru_cell":
            total += (op.d_in + op.d_out) * 3 * op.d_out
        elif op.kind == "conv_dw":
            total += op.rs * op.rs * op.d_in
        elif op.kind == "ib_fused":
            total += (op.d_in * op.d_mid + op.rs * op.rs * op.d_mid
                      + op.d_mid * op.d_out)
        elif op.kind == "fused_mlp":
            total += 3 * op.d_in * op.d_ff
    return total * 4


def _to_host(obj):
    """A params structure with every tensor as a host numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(_to_host(v) for v in obj)
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    return obj


def _device(device) -> torch.device:
    """The device to run on: the CUDA card unless ``device`` says
    otherwise; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and CUDA is "
                "not available here; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class CompiledNet:
    """A deployed network: one solved ring plus what it needs to run,
    report and save.  An int8 net holds ``qnet`` (its ``qparams``), a
    float net its fp32 ``params`` and no ``qnet``; both hold numpy
    arrays, which :meth:`run` copies to each device it runs on, once.
    ``plan``/``graph`` carry the NetPlan and IR of an in-process compile
    and are ``None`` after :meth:`load`.  The device copies are a cache
    of this net's own tables: ``dataclasses.replace`` starts the new net
    with none, and equality ignores them."""

    net_name: str
    target: Target
    dtype: str
    program: PoolProgram
    qnet: QuantizedNet | None
    mcu: dict
    certificate: dict | None
    passes: list
    partial: dict | None = None
    params: list | None = None
    plan: NetPlan | None = None
    graph: Graph | None = None
    init_key: object = None    # seed or generator for lazy param init
    spans: list | None = None  # nested timed pipeline spans (obs.spans)
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def quantized(self) -> bool:
        return self.qnet is not None

    @property
    def partial_parents(self) -> list[int] | None:
        """Sliced-op -> unsliced-op index map (``None`` when unsliced)."""
        if self.partial is None:
            return None
        return self.partial.get("parents")

    def ensure_params(self) -> list:
        """Materialize the float parameters on first need (run/save of a
        planner-only compile) with :func:`init_net_params`; quantized
        compiles already carry them."""
        if self.params is None:
            if self.plan is None:
                raise CompileError("no parameters in this CompiledNet "
                                   "and no plan to initialize them from")
            base = init_net_params(self.plan, self.init_key)
            parents = self.partial_parents
            self.params = (base if parents is None
                           else [base[p] for p in parents])
        return self.params

    @property
    def pool_bytes(self) -> int:
        """The executed ring footprint (bytes of pool state)."""
        return self.program.pool_bytes

    @property
    def mcu_bottleneck_bytes(self) -> int:
        """The byte-granular deployable bottleneck (paper Fig. 9/10)."""
        return self.mcu["mcu_bottleneck_bytes"]

    def _dedup_by_parent(self, entries: list) -> list:
        """Slices of one op share its parameters — count flash once."""
        parents = self.partial_parents
        if parents is None:
            return entries
        seen: set[int] = set()
        kept = []
        for p, e in zip(parents, entries):
            if p not in seen:
                seen.add(p)
                kept.append(e)
        return kept

    @property
    def flash_bytes_used(self) -> int:
        """Parameter storage the target's flash must hold (exact for
        materialized params/qparams, analytic otherwise)."""
        if self.quantized:
            return _nbytes(self._dedup_by_parent(self.qnet.qparams))
        if self.params is not None:
            return _nbytes(self._dedup_by_parent(self.params))
        return _flash_param_bytes(self.program, self.partial_parents)

    def fits(self) -> bool:
        return self.target.fits_sram(self.mcu_bottleneck_bytes)

    def _qnet_on(self, dev: torch.device) -> QuantizedNet:
        key = str(dev)
        if key not in self._on_device:
            self._on_device[key] = dataclasses.replace(
                self.qnet, qparams=artifact.to_device(self.qnet.qparams,
                                                      dev))
        return self._on_device[key]

    def _params_on(self, dev: torch.device) -> list:
        key = str(dev)
        if key not in self._on_device:
            self._on_device[key] = artifact.to_device(self.ensure_params(),
                                                      dev)
        return self._on_device[key]

    def run(self, x, *, device=None, trace: bool = False):
        """Run the net on float input ``x`` — one sample ``[rows, d]`` or
        a batch ``[B, rows, d]`` — and return float output on
        ``device`` (the CUDA card when ``None``).  An int8 net quantizes
        on entry and dequantizes on exit; a float net stages ``x`` as it
        is.  A batch runs every sample through the one solved plan in
        turn.

        ``trace=True`` threads a :class:`repro_torch.obs.RingTracer`
        through the executor (per-op wall times: CUDA events on the card,
        the host clock on the CPU) and returns ``(y, TraceArtifact)``
        instead of ``y``.  ``trace=False`` records no event and adds no
        synchronize; the output is the same bits either way.  A batched
        trace is one artifact whose counters are the certificate scaled
        by exactly the batch (wall times sum across samples)."""
        if not self.quantized and self.program.quantized:
            raise CompileError(
                "this is a planner-only int8 compile (quantize=False): "
                "the ring geometry exists but no calibrated qparams — "
                "recompile with quantize=True to execute")
        dev = _device(device)
        kbr = self.target.kernel_block_rows
        x = torch.as_tensor(x, device=dev)
        if self.quantized:
            qnet = self._qnet_on(dev)

            def one(xi, tracer=None):
                return run_net_quantized(qnet, xi, kernel_block_rows=kbr,
                                         tracer=tracer)
        else:
            params = self._params_on(dev)
            x = x.to(torch.float32)

            def one(xi, tracer=None):
                return run_net(self.program, xi, params,
                               kernel_block_rows=kbr, tracer=tracer)
        if not trace:
            if x.ndim == 3:
                return torch.stack([one(xi) for xi in x])
            return one(x)
        from ..obs import RingTracer

        if x.ndim == 3:
            return self._run_batch_traced(x, one)
        tracer = RingTracer()
        y = one(x, tracer)
        return y, self._trace(tracer)

    def _trace(self, tracer):
        from ..obs import build_trace

        return build_trace(self.program, tracer=tracer, net=self.net_name,
                           target=self.target.name, spans=self.spans)

    def _run_batch_traced(self, x: torch.Tensor, one):
        """Batched ``trace=True``: every sample runs through the ONE
        solved plan with its own tracer; wall times sum across samples
        and the schedule-derived counters scale by exactly the batch —
        the certificate × batch invariant the tests pin.  (The
        occupancy timeline and watermark stay per sample: each runs its
        own pool.)"""
        from ..obs import RingTracer

        agg = RingTracer(backend=x.device.type)
        ys = []
        for xi in x:
            t = RingTracer()
            ys.append(one(xi, t))
            for i, s in t.wall_s.items():
                agg.wall_s[i] = agg.wall_s.get(i, 0.0) + s
        art = self._trace(agg)
        batch = int(x.shape[0])
        scaled = ("steps", "segs_read", "segs_written", "bytes_loaded",
                  "bytes_stored", "macs", "requants")
        for ev in art.events:
            for k in scaled:
                if k in ev:
                    ev[k] = ev[k] * batch
        for k in scaled:
            if k in art.totals:
                art.totals[k] = art.totals[k] * batch
        art.totals["batch"] = batch
        return torch.stack(ys), art

    def profile(self, x=None, *, device=None):
        """One traced run on ``x`` (a seeded normal input when ``None``);
        returns the :class:`repro_torch.obs.TraceArtifact` (geometry,
        per-op byte/MAC counters + wall times, occupancy timeline,
        compile spans).

        Planner-only int8 compiles (no qparams) profile through the sim
        oracle on the host instead — measured segment traffic, no
        numerics."""
        if self.program.quantized and not self.quantized:
            from ..core.executors import run_program_sim
            from ..obs import RingTracer

            tracer = RingTracer()
            run_program_sim(self.program, tracer=tracer)
            return self._trace(tracer)
        if x is None:
            x = np.random.default_rng(0).standard_normal(
                (self.program.in_rows, self.program.in_dim), np.float32)
        _y, art = self.run(x, device=device, trace=True)
        return art

    def stream(self, device=None, *, backend: str | None = None,
               trace: bool = False):
        """Open a :class:`repro_torch.stream.StreamSession` on this net —
        the per-frame reset/step driver over the persistent-state ring,
        on ``device`` (the CUDA card when ``None``).  Needs a streaming
        plan (``conv_stream``/``gru_cell`` ops), int8 or float."""
        from ..stream import StreamSession

        return StreamSession(self, device, backend=backend, trace=trace)

    def emit_c(self, outdir=None, *, name: str | None = None,
               geometry_only: bool = False,
               idiom: str | None = _UNSET) -> dict[str, str]:
        """Emit one intrinsic-C unit per op (``{filename: source}``).

        Quantized nets bake their requant tables in (from the host numpy
        ``qnet.qparams``); ``geometry_only`` emits just the solved ring
        skeleton (byte-typed pool header, no requant constants — the
        deterministic form the CLI smoke gate diffs against goldens).
        ``idiom`` defaults to the target's requant idiom banner.
        ``outdir`` additionally writes the files.
        """
        if idiom is _UNSET:
            idiom = (self.target.requant_idiom
                     if self.target.requant_idiom != "none" else None)
        name = name or self.net_name
        if geometry_only or not self.quantized:
            if not geometry_only and self.program.quantized:
                raise CompileError(
                    "this is a planner-only int8 compile (quantize="
                    "False): no requant tables to bake — recompile with "
                    "quantize=True, or pass geometry_only=True for the "
                    "ring skeleton")
            prog = (self.program.with_dtype("byte") if geometry_only
                    else self.program)
            units = emit_program(prog, name, idiom=idiom)
        else:
            units = emit_program(self.qnet.program, name,
                                 quant=_to_host(self.qnet.qparams),
                                 idiom=idiom)
        if outdir is not None:
            import pathlib

            out = pathlib.Path(outdir)
            out.mkdir(parents=True, exist_ok=True)
            for fname, src in units.items():
                (out / fname).write_text(src)
        return units

    def report(self) -> dict:
        """Footprint / bottleneck accounting against the target budget."""
        t = self.target
        bot = self.mcu_bottleneck_bytes
        deploy = self.mcu.get("deploy_bytes") or bot
        flash = self.flash_bytes_used
        return {
            "net": self.net_name,
            "target": t.name,
            "cpu": t.cpu,
            "dtype": self.dtype,
            "n_ops": len(self.program.ops),
            "pool_bytes": self.pool_bytes,
            "physical_pool_bytes": self.program.physical_pool_bytes,
            "mcu_bottleneck_bytes": bot,
            "tinyengine_bottleneck_bytes":
                self.mcu.get("tinyengine_bottleneck_bytes"),
            "hmcos_bottleneck_bytes":
                self.mcu.get("hmcos_bottleneck_bytes"),
            "reduction_vs_tinyengine":
                self.mcu.get("reduction_vs_tinyengine"),
            "reduction_vs_hmcos": self.mcu.get("reduction_vs_hmcos"),
            "bottleneck_group": self.mcu.get("bottleneck_group"),
            "byte_ring_bytes": self.mcu.get("byte_ring_bytes"),
            "deploy_bytes": self.mcu.get("deploy_bytes"),
            "partial": self.mcu.get("partial"),
            "sram_bytes": t.sram_bytes,
            "sram_margin_bytes": t.sram_margin(deploy),
            "fits_sram": t.fits_sram(deploy),
            "flash_bytes": t.flash_bytes,
            "flash_bytes_used": flash,
            "fits_flash": flash <= t.flash_bytes,
            "certificate": self.certificate,
            "passes": [[p.name, round(p.seconds, 4), p.note]
                       for p in self.passes],
        }

    # -- plan artifacts ----------------------------------------------------
    def save(self, path) -> str:
        """Write the solved plan + payloads as a JSON artifact — the
        reference's ``save()`` format, so either package loads it.  A
        compiled float net saves its fp32 params (drawn first where the
        compile had none); a loaded net saves what it holds."""
        params = (self.ensure_params() if self.plan is not None
                  else self.params)
        payload = {
            "schema": artifact.SCHEMA,
            "kind": artifact.KIND,
            "net": self.net_name,
            "target": dataclasses.asdict(self.target),
            "dtype": self.dtype,
            "program": self.program.to_json_dict(),
            "params": artifact.encode(params),
            "quant": None if not self.quantized else {
                "act_scales": list(self.qnet.act_scales),
                "qparams": artifact.encode(self.qnet.qparams),
            },
            "mcu": self.mcu,
            "certificate": self.certificate,
            "passes": [[p.name, p.seconds, p.note] for p in self.passes],
            "spans": self.spans,
            "partial": self.partial,
        }
        artifact.dump(payload, path)
        return path

    @classmethod
    def load(cls, path) -> "CompiledNet":
        return cls.from_payload(artifact.load(path), where=path)

    @classmethod
    def from_payload(cls, payload: dict, *, where="the artifact",
                     params: list | None = None) -> "CompiledNet":
        """A net from a decoded artifact ``payload`` (:func:`load` reads
        one from ``where``).  A float plan runs with the artifact's fp32
        ``params`` or, where the artifact has none, with the ``params``
        the caller supplies (numpy arrays, one entry per op); without
        either it is refused."""
        target = Target(**payload["target"])
        program = PoolProgram.from_json_dict(payload["program"])
        cert = payload.get("certificate")
        if cert is not None and "program_sha256" in cert:
            have = artifact.program_sha256(program)
            if cert["program_sha256"] != have:
                raise CompileError(
                    f"VMCU403: {where} certificate does not match its "
                    f"program (certified {cert['program_sha256'][:12]}"
                    f"..., stored {have[:12]}...) — the plan changed "
                    "after it was certified")
        stored = artifact.decode(payload.get("params"))
        if params is None:
            params = stored
        elif stored is not None:
            raise ValueError(f"{where} holds its own params")
        elif len(params) != len(program.ops):
            raise ValueError(f"{len(params)} param entries for "
                             f"{len(program.ops)} ops")
        qnet = None
        if payload["quant"] is not None:
            qnet = QuantizedNet(
                plan=None, program=program, params=None,
                qparams=artifact.decode(payload["quant"]["qparams"]),
                act_scales=tuple(payload["quant"]["act_scales"]))
        elif params is None:
            raise CompileError(f"{where} holds a float plan without its "
                               "fp32 params: nothing to run it with")
        return cls(net_name=payload["net"], target=target,
                   dtype=payload["dtype"], program=program, qnet=qnet,
                   mcu=payload["mcu"], certificate=cert,
                   passes=[PassRecord(n, s, note)
                           for n, s, note in payload["passes"]],
                   partial=payload.get("partial"), params=params,
                   spans=payload.get("spans"))


def load(path) -> CompiledNet:
    """Load a saved plan artifact (module-level alias)."""
    return CompiledNet.load(path)


# ---------------------------------------------------------------------------
# The pipeline.
# ---------------------------------------------------------------------------

def _mcu_summary(plan: NetPlan) -> dict:
    """Snapshot the byte-granular accounting so it survives save/load."""
    return {
        "mcu_bottleneck_bytes": plan.mcu_bottleneck_bytes,
        "tinyengine_bottleneck_bytes": plan.tinyengine_bottleneck_bytes,
        "hmcos_bottleneck_bytes": plan.hmcos_bottleneck_bytes,
        "reduction_vs_tinyengine": plan.reduction_vs_tinyengine,
        "reduction_vs_hmcos": plan.reduction_vs_hmcos,
        "mcu_pool_bytes": plan.mcu_pool_bytes,
        "bottleneck_group": plan.bottleneck_group().name,
        "n_groups": len(plan.groups),
        "groups": [{"name": g.name, "kind": g.group.kind,
                    "fused_exec": g.group.fused_exec,
                    "mcu_bytes": g.group.mcu_bytes,
                    "te_bytes": g.group.te_bytes,
                    "hmcos_bytes": g.group.hmcos_bytes}
                   for g in plan.groups],
    }


def compile(net, target: str | Target = "host-sim", *, dtype=None,
            fused_exec: bool | None = None, seg_width: int | None = None,
            block_rows=_UNSET, order=None, params=None, key=None,
            calib=None, n_calib: int = 2, quantize: bool = True,
            certify: bool | str = True, lint: bool = True,
            check_budget: bool = True, partial: str | int = "off",
            streaming: bool = False) -> CompiledNet:
    """Compile ``net`` for ``target`` — the port's deployment front door,
    with the reference's signature and defaults.

    ``net`` is a :class:`repro_torch.graph.ir.Graph` or a registered net
    name (:func:`available_nets`); ``target`` a :class:`Target` or
    registry name.  Every knob defaults from the target descriptor:
    ``dtype`` (``target.default_dtype``), ring geometry (``seg_width`` /
    ``block_rows``), and ``fused_exec`` (unfused for int8 — the
    deployment form quantization requires).  ``streaming=True`` converts
    the graph to its per-frame form (:func:`repro_torch.stream.
    to_streaming`) before planning; run the result with
    :meth:`CompiledNet.stream`.

    The compile runs on the host.  ``params`` are the float parameters,
    one entry per op as the artifact codec decodes them (numpy arrays or
    tensors); without them :func:`init_net_params` draws them from a
    ``torch.Generator`` seeded with ``key`` (0 when ``None``), lazily on
    a float compile — so a compile without params does not reproduce
    the reference's JAX draws.  ``calib`` (``[n, rows, d]``) feeds int8
    calibration, drawn the same way (``n_calib`` inputs) when omitted;
    calibration's forward runs on the CPU in float32, where the
    reference's runs.  ``quantize=False`` plans an int8 ring without
    calibrating (planner-only, ``.run`` unavailable); ``certify`` is
    ``True``/``"sim"`` (replay the SegmentPool clobber oracle),
    ``"static"`` (prove the plan with
    :func:`repro_torch.analysis.verify_program`: an unsafe plan raises
    :class:`CompileError`, and a plan outside the proof's fragment is
    replayed through the sim oracle, its pass note starting
    ``sim fallback (VMCU105)``) or ``False`` (skip); ``lint=False``
    skips the VMCU3xx/4xx lint pass; ``check_budget=False`` records the
    SRAM verdict without raising :class:`SRAMBudgetError`.

    ``partial`` enables partial execution (:mod:`repro_torch.partial`):
    ``"auto"`` slices over-budget fusion groups spatially until the
    deployable ring fits the target SRAM (demoting
    :class:`SRAMBudgetError` into a scheduled latency/memory trade), an
    ``int`` forces that many slices on the ring-pinning group, ``"off"``
    (default) keeps the hard budget gate.  An int8 net is calibrated on
    the unsliced plan and each op's qparams are shared across its
    slices, so sliced execution is bit for bit the unsliced one.
    """
    if certify not in (True, False, "sim", "static"):
        raise ValueError(f"certify must be True/False/'sim'/'static', "
                         f"got {certify!r}")
    if not (partial in ("off", "auto") or isinstance(partial, int)):
        raise ValueError(f"partial must be 'off', 'auto' or an int "
                         f"slice count, got {partial!r}")
    t = get_target(target)
    dtype = dtype or t.default_dtype
    dtype_itemsize(dtype)  # fail fast on unknown dtypes
    if fused_exec is None:
        # partial execution slices the unfused pw/dw/pw chain — the
        # same deployment form int8 quantization requires
        fused_exec = dtype != "int8" and partial == "off"
    elif fused_exec and dtype == "int8":
        raise CompileError(
            "int8 compilation requires unfused module lowering "
            "(fused_exec=False): quantized execution requantizes "
            "between the pw/dw/pw ops")
    elif fused_exec and partial != "off":
        raise CompileError(
            "partial execution requires unfused module lowering "
            "(fused_exec=False): the slice surgery rewrites the "
            "pw/dw/pw chain ops individually")
    seg_width = t.seg_width if seg_width is None else seg_width
    block_rows = t.block_rows if block_rows is _UNSET else block_rows
    params = _to_host(params)

    passes: list[PassRecord] = []
    collector = SpanCollector()

    def run_pass(name, fn):
        t0 = time.perf_counter()
        with collect(collector), span(name):
            out, note = fn()
        passes.append(PassRecord(name, time.perf_counter() - t0, note))
        return out

    # build ----------------------------------------------------------------
    def _build():
        g = _resolve_net(net)
        note = ""
        if streaming:
            from ..stream import to_streaming

            g = to_streaming(g)
            note = " (streaming form)"
        g.validate()
        return g, f"{len(g.nodes)} nodes, {len(g.modules)} modules{note}"
    graph = run_pass("build", _build)

    # schedule -------------------------------------------------------------
    def _schedule():
        if order is not None:
            return list(order), f"caller order ({len(order)} nodes)"
        o, peak = reorder(graph)
        return o, f"peak live {peak} B over {len(o)} nodes"
    sched_order = run_pass("schedule", _schedule)

    # plan -----------------------------------------------------------------
    def _plan():
        p = _plan_net(graph, order=sched_order, seg_width=seg_width,
                      block_rows=block_rows, dtype=dtype,
                      fused_exec=fused_exec)
        return p, (f"{len(p.program.ops)} ops in one ring, "
                   f"pool {p.program.pool_bytes} B")
    plan = run_pass("plan", _plan)

    # budget ---------------------------------------------------------------
    # Pure arithmetic on the solved plans, before the expensive passes.
    # For int8 (the deployment dtype) the gate covers both the analytic
    # per-group bottleneck and the deployable byte ring (seg_width=1,
    # tight rows), which a merged multi-group ring can exceed the
    # per-group bound on.  Float compiles keep the analytic gate.
    byte_geometry = seg_width == 1 and block_rows is None
    real_mcu = t.sram_bytes < (1 << 38)     # host-sim never gates
    ring_gate = dtype == "int8" or partial != "off"
    byte_plan = None
    if real_mcu and ring_gate and (check_budget or partial != "off") \
            and not byte_geometry:
        try:
            with collect(collector), span("byte_plan"):
                byte_plan = _plan_net(graph, order=sched_order, dtype=dtype,
                                      fused_exec=fused_exec,
                                      **t.byte_ring_kwargs)
        except Exception:
            byte_plan = None        # fall back to the analytic gate only

    def _budget():
        bot = plan.mcu_bottleneck_bytes
        ring = (byte_plan.program.pool_bytes if byte_plan is not None
                else plan.program.pool_bytes
                if byte_geometry and ring_gate else bot)
        deploy = max(bot, ring)
        margin = t.sram_margin(deploy)
        verdict = "fits" if margin >= 0 else "OVER"
        note = (f"bottleneck {bot} B, deployable ring {ring} B vs "
                f"{t.sram_bytes} B SRAM ({verdict}, margin {margin} B)")
        if margin < 0 and partial != "off":
            return (deploy, margin), note + " — deferred to partial pass"
        if check_budget and margin < 0:
            raise SRAMBudgetError(
                f"{graph.name} needs {deploy} B (deployable "
                f"bottleneck) but target {t.name!r} has {t.sram_bytes} "
                f"B SRAM (over by {-margin} B); pass partial='auto' to "
                "slice the over-budget groups, or check_budget=False "
                "to record the verdict without gating")
        return (deploy, margin), note
    run_pass("budget", _budget)

    # partial --------------------------------------------------------------
    # Slice over-budget fusion groups spatially.  The slicing is CHOSEN on
    # the deployable byte ring (that is the budget being missed) and
    # APPLIED to the executed geometry too.
    partial_plan = None
    exec_parents = None
    exec_program = plan.program
    if partial != "off":
        def _partial():
            nonlocal exec_parents, exec_program
            from ..partial import (PartialPlanError, apply_partial,
                                   plan_partial)

            policy = byte_plan if byte_plan is not None else plan
            ranges = [(gp.op_lo, gp.op_hi) for gp in policy.groups]
            force = partial if isinstance(partial, int) else None
            try:
                pp = plan_partial(policy.program, ranges, t.sram_bytes,
                                  force=force)
            except PartialPlanError as e:
                raise SRAMBudgetError(
                    f"partial execution cannot fit {graph.name} in "
                    f"{t.sram_bytes} B SRAM on {t.name!r}: {e}") from e
            if pp is None:
                return None, "not needed (deployable ring fits SRAM)"
            exec_program, exec_parents = apply_partial(plan.program,
                                                       pp.choices)
            return pp, (f"{len(pp.groups)} group(s) -> "
                        f"{sum(g['n_slices'] for g in pp.groups)} "
                        f"slices; ring {pp.ring_bytes_before} -> "
                        f"{pp.ring_bytes_after} B, "
                        f"+{pp.mac_overhead:.1%} MACs")
        partial_plan = run_pass("partial", _partial)

    # quantize -------------------------------------------------------------
    # (float parameters materialize lazily: planner-only compiles never
    # pay for init_net_params)
    qnet = None
    if dtype == "int8" and quantize:
        def _quant():
            nonlocal params
            if params is None:
                with span("init_params", ops=len(plan.program.ops)):
                    params = init_net_params(plan, key)
            q = _quantize_net(plan, params, calib=calib, n_calib=n_calib,
                              key=key)
            note = (f"{len(q.qparams)} q-ops, requant tables for "
                    f"{sum(1 for op in q.program.ops if op.kind != 'add')}"
                    " stores")
            if partial_plan is not None:
                # calibrated on the UNSLICED plan; each op's qparams are
                # shared across its slices, so requant constants match
                from ..partial import apply_partial

                qprog, qpar = apply_partial(q.program,
                                            partial_plan.choices)
                q = QuantizedNet(
                    plan=q.plan, program=qprog,
                    params=[q.params[p] for p in qpar],
                    qparams=[q.qparams[p] for p in qpar],
                    act_scales=q.act_scales)
                note += f"; shared across {len(qpar)} sliced ops"
            return q, note
        qnet = run_pass("quantize", _quant)

    program = qnet.program if qnet is not None else exec_program

    # deployable accounting shared by lint / mcu snapshot / report ---------
    ring_unsliced = (byte_plan.program.pool_bytes
                     if byte_plan is not None
                     else plan.program.pool_bytes
                     if byte_geometry and ring_gate else None)
    deploy_ring = (partial_plan.ring_bytes_after
                   if partial_plan is not None else ring_unsliced)
    deploy_bytes = max(plan.mcu_bottleneck_bytes, deploy_ring or 0)

    # lint -----------------------------------------------------------------
    if lint:
        def _lint():
            from ..analysis.lint import lint_program

            est = None
            if t.sram_margin(deploy_bytes) < 0 and partial_plan is None:
                # the overflow stood — can partial execution resolve it?
                from ..partial import estimate_slices

                policy = byte_plan if byte_plan is not None else plan
                pprog = policy.program
                est = estimate_slices(
                    pprog, [(gp.op_lo, gp.op_hi) for gp in policy.groups],
                    t.sram_bytes // (pprog.seg_width * pprog.elem_bytes))
            diags = lint_program(
                program, t, deploy_bytes=deploy_bytes,
                bottleneck_group=plan.bottleneck_group().name,
                partial_slices=est)
            # check_budget=False means "record, don't gate" — that
            # covers the lint pass's SRAM finding too
            errors = [d for d in diags if d.severity == "error"
                      and (check_budget or d.code != "VMCU301")]
            if errors:
                raise CompileError(f"lint: {errors[0]}")
            if diags:
                return None, (f"{len(diags)} warning(s): "
                              + "; ".join(str(d) for d in diags))
            return None, "clean"
        run_pass("lint", _lint)

    # certify --------------------------------------------------------------
    certificate = None
    if certify:
        def _certify():
            note = ""
            if certify == "static":
                from ..analysis import verify_program

                res = verify_program(program)
                if res.safe is False:
                    raise CompileError(f"certify: {res.diagnostics[0]}")
                if res.safe:
                    cert = res.certificate(
                        artifact.program_sha256(program))
                    return cert, (f"static proof: zero clobbers; peak "
                                  f"{cert['peak_live']}/"
                                  f"{program.n_segments} segments live")
                note = f"sim fallback ({res.diagnostics[0].code}); "
            sim = certify_net(program)
            cert = {"clobbers": 0, "peak_live": sim.peak_live,
                    "reads": sim.reads, "writes": sim.writes,
                    "n_segments": program.n_segments,
                    "program_sha256": artifact.program_sha256(program)}
            state_total = sum(op.state_segments for op in program.ops)
            if state_total:
                # only the state regions and the final output survive
                # the step: the end-live invariant of an unbounded horizon
                cert["n_states"] = sum(1 for op in program.ops
                                       if op.state_segments)
                cert["state_segments"] = state_total
                cert["stream_horizon"] = (
                    "unbounded" if sim.live == state_total
                    + program.ops[-1].out_segments else 1)
            return cert, (f"{note}zero clobbers; peak {sim.peak_live}/"
                          f"{program.n_segments} segments live")
        certificate = run_pass("certify", _certify)

    mcu = _mcu_summary(plan)
    mcu["byte_ring_bytes"] = ring_unsliced
    mcu["deploy_bytes"] = deploy_bytes
    partial_info = None
    if partial_plan is not None:
        partial_info = dict(partial_plan.summary())
        partial_info["parents"] = list(exec_parents)
        mcu["partial"] = {k: v for k, v in partial_info.items()
                          if k != "parents"}
        if params is not None:     # re-align materialized float params
            params = [params[p] for p in exec_parents]

    return CompiledNet(net_name=graph.name, target=t, dtype=dtype,
                       program=program, qnet=qnet, mcu=mcu,
                       certificate=certificate, passes=passes,
                       params=params, plan=plan, graph=graph,
                       init_key=key, spans=collector.to_dicts(),
                       partial=partial_info)
