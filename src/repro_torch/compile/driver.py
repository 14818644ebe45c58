"""Serve a compiled network from its plan artifact.

Counterpart of the deployment half of :mod:`repro.compile.driver`: a
:class:`CompiledNet` loaded from the JSON artifact that
``repro.compile(net, target).save(path)`` writes.  Loading never re-runs
the planner, and checks that the stored program is the one its
certificate proved safe (VMCU403).  The compile pipeline itself is a
later slice.

A float plan (the ``host-sim`` target's default) carries its fp32
``params`` in the artifact; an int8 plan carries its calibrated
``quant`` payload and may leave ``params`` out.  A float artifact saved
without its params (weights too large to commit) runs only with params
the caller supplies, through :meth:`CompiledNet.from_payload` —
``repro_torch.kernels.cases.seeded_float_net`` builds them from a numpy
seed.  ``CompiledNet.run``
runs either on the CUDA card unless the caller passes ``device="cpu"``;
without a card it raises rather than run elsewhere.
``CompiledNet.stream`` opens a :class:`repro_torch.stream.StreamSession`
on a streaming plan, int8 or float, on the same terms.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.program import PoolProgram
from ..graph.run import QuantizedNet, run_net, run_net_quantized
from . import artifact
from .targets import Target


class CompileError(Exception):
    """A compiled net is unusable (e.g. its plan changed after it was
    certified)."""


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
    """A deployed network: one solved ring plus what it needs to run and
    report.  An int8 net holds ``qnet`` (its ``qparams``), a float net
    its fp32 ``params`` and no ``qnet``; both hold numpy arrays, which
    :meth:`run` copies to each device it runs on, once."""

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
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def quantized(self) -> bool:
        return self.qnet is not None

    @property
    def pool_bytes(self) -> int:
        """The executed ring footprint (bytes of pool state)."""
        return self.program.pool_bytes

    @property
    def mcu_bottleneck_bytes(self) -> int:
        """The byte-granular deployable bottleneck (paper Fig. 9/10)."""
        return self.mcu["mcu_bottleneck_bytes"]

    @property
    def flash_bytes_used(self) -> int:
        """Parameter storage the target's flash must hold; slices of one
        op share its parameters and count once."""
        entries = self.qnet.qparams if self.quantized else self.params
        parents = (self.partial or {}).get("parents")
        if parents is not None:
            seen: set[int] = set()
            kept = []
            for p, e in zip(parents, entries):
                if p not in seen:
                    seen.add(p)
                    kept.append(e)
            entries = kept
        return _nbytes(entries)

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
            self._on_device[key] = artifact.to_device(self.params, dev)
        return self._on_device[key]

    def run(self, x, *, device=None) -> torch.Tensor:
        """Run the net on float input ``x`` — one sample ``[rows, d]`` or
        a batch ``[B, rows, d]`` — and return float output on
        ``device`` (the CUDA card when ``None``).  An int8 net quantizes
        on entry and dequantizes on exit; a float net stages ``x`` as it
        is.  A batch runs every sample through the one solved plan in
        turn."""
        dev = _device(device)
        kbr = self.target.kernel_block_rows
        x = torch.as_tensor(x, device=dev)
        if self.quantized:
            qnet = self._qnet_on(dev)

            def one(xi):
                return run_net_quantized(qnet, xi, kernel_block_rows=kbr)
        else:
            params = self._params_on(dev)
            x = x.to(torch.float32)

            def one(xi):
                return run_net(self.program, xi, params,
                               kernel_block_rows=kbr)
        if x.ndim == 3:
            return torch.stack([one(xi) for xi in x])
        return one(x)

    def stream(self, device=None, *, backend: str | None = None,
               trace: bool = False):
        """Open a :class:`repro_torch.stream.StreamSession` on this net —
        the per-frame reset/step driver over the persistent-state ring,
        on ``device`` (the CUDA card when ``None``).  Needs a streaming
        plan (``conv_stream``/``gru_cell`` ops), int8 or float."""
        from ..stream import StreamSession

        return StreamSession(self, device, backend=backend, trace=trace)

    def report(self) -> dict:
        """Footprint / bottleneck accounting against the target budget,
        from the fields stored in the artifact."""
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
                   partial=payload.get("partial"), params=params)


def load(path) -> CompiledNet:
    """Load a saved plan artifact (module-level alias)."""
    return CompiledNet.load(path)
