"""Receiver checkpoint / resume.

The firmware has no checkpointing; its closest analogue is warm-start
Doppler seeding (gps_master.c:490-510, SURVEY.md §5).  Here the entire
receiver is explicit state: the device-side TrackState pytree plus the
host-side channel bookkeeping (framers, ephemerides, ledgers), so a
streaming job can stop mid-capture and resume bit-exactly.

Format: a single .npz holding the TrackState leaves + the host state as
a JSON document (UTF-8 bytes).  The host state is plain dataclasses of
scalars/lists/small arrays; they are encoded structurally against an
explicit class ALLOWLIST (no pickle anywhere), so loading a checkpoint
can never execute code it carries — the loader-trust hazard of the
previous pickle blob is closed.  Unknown classes or malformed payloads
raise instead of instantiating anything.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from ..track.state import TrackState

_FORMAT_VERSION = 2


def _registry() -> dict:
    """name -> class allowlist for the structured host-state codec.
    Built lazily (imports cross module boundaries)."""
    from ..acquire.engine import AcqResult
    from ..config import AcqConfig, ReceiverConfig, SignalPlan, TrackConfig
    from ..nav.ephemeris import Ephemeris
    from ..nav.frame import NavFramer
    from ..pvt.gpstime import GTime
    from ..pvt.observables import HatchState
    from ..pvt.solve import Solution
    from .receiver import ChannelStatus

    return {
        c.__name__: c
        for c in (
            ReceiverConfig, SignalPlan, AcqConfig, TrackConfig,
            ChannelStatus, NavFramer, Ephemeris, GTime, HatchState,
            AcqResult, Solution,
        )
    }


def _encode(obj):
    """Host object -> JSON-compatible structure (allowlisted classes,
    tuples, bytes, numpy arrays/scalars, and JSON primitives)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        v = obj.item()
        if isinstance(v, complex):
            return {"__c__": [v.real, v.imag]}
        return v
    if isinstance(obj, complex):
        return {"__c__": [obj.real, obj.imag]}
    if isinstance(obj, (bytes, bytearray)):
        return {"__b__": bytes(obj).hex()}
    if isinstance(obj, tuple):
        return {"__t__": [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, (np.ndarray, jnp.ndarray)):
        a = np.asarray(obj)
        if np.iscomplexobj(a):
            data = [a.real.tolist(), a.imag.tolist()]
        else:
            data = a.tolist()
        return {"__nd__": {"dtype": str(a.dtype), "shape": list(a.shape),
                           "data": data}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"checkpoint: {name} is not allowlisted")
        return {"__dc__": name,
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("checkpoint: only str dict keys supported")
        return {"__m__": {k: _encode(v) for k, v in obj.items()}}
    raise TypeError(f"checkpoint: cannot encode {type(obj).__name__}")


def _decode(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    if isinstance(obj, dict):
        if "__c__" in obj:
            re_v, im_v = obj["__c__"]
            return complex(re_v, im_v)
        if "__b__" in obj:
            return bytes.fromhex(obj["__b__"])
        if "__t__" in obj:
            return tuple(_decode(v) for v in obj["__t__"])
        if "__nd__" in obj:
            d = obj["__nd__"]
            dtype = np.dtype(d["dtype"])
            if dtype.kind == "c":
                re_a, im_a = d["data"]
                a = np.asarray(re_a, np.float64) \
                    + 1j * np.asarray(im_a, np.float64)
                return a.astype(dtype).reshape(d["shape"])
            return np.asarray(d["data"], dtype).reshape(d["shape"])
        if "__dc__" in obj:
            cls = _registry().get(obj["__dc__"])
            if cls is None:
                raise ValueError(
                    f"checkpoint: unknown class {obj['__dc__']!r}")
            return cls(**{k: _decode(v)
                          for k, v in obj["fields"].items()})
        if "__m__" in obj:
            return {k: _decode(v) for k, v in obj["__m__"].items()}
        raise ValueError(f"checkpoint: unknown tag {sorted(obj)}")
    raise ValueError(f"checkpoint: cannot decode {type(obj).__name__}")


def save_receiver(path: str, receiver) -> str:
    """Write the checkpoint; returns the actual file path (numpy appends
    .npz when missing, which would otherwise break load_receiver)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays = {}
    if receiver.track_state is not None:
        for f in TrackState._fields:
            arrays[f"ts_{f}"] = np.asarray(getattr(receiver.track_state, f))
        # the raw (C, 1023) bipolar table the tracking scan reads
        arrays["code_table"] = np.asarray(receiver.code_table)
    host = dict(
        version=_FORMAT_VERSION,
        config=receiver.config,
        channels=receiver.channels,
        epoch_cursor=receiver.epoch_cursor,
        solutions=receiver.solutions,
        solution_epochs=receiver.solution_epochs,
        last_solve_ms=receiver._last_solve_ms,
        # cadence/standby/aided-sync ledgers — without these, resume
        # drops late-rise PRNs and restarts the RTCM/reacq clocks
        standby_channels=receiver.standby_channels,
        rtcm_frames=receiver.rtcm_frames,
        last_rtcm_ms=receiver._last_rtcm_ms,
        last_reacq_ms=receiver._last_reacq_ms,
        flip_hist=receiver._flip_hist,
        flip_hist_ms=receiver._flip_hist_ms,
        flip_prev_sign=receiver._flip_prev_sign,
        aided_low_conf=receiver._aided_low_conf,
        pending_phase=receiver._pending_phase,
        pending_cnt=receiver._pending_cnt,
        phase_ref_prn=receiver._phase_ref_prn,
    )
    blob = json.dumps(_encode(host)).encode("utf-8")
    arrays["host_json"] = np.frombuffer(blob, dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_receiver(path: str):
    from .receiver import Receiver

    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    if "host_json" not in data:
        raise ValueError(
            "checkpoint predates the structured (pickle-free) format; "
            "re-save it with this version")
    host = _decode(json.loads(data["host_json"].tobytes().decode("utf-8")))
    rx = Receiver(host["config"])
    rx.channels = host["channels"]
    rx.epoch_cursor = int(host["epoch_cursor"])
    rx.solutions = host["solutions"]
    rx.solution_epochs = host["solution_epochs"]
    rx._last_solve_ms = int(host["last_solve_ms"])
    rx.standby_channels = host.get("standby_channels", [])
    rx.rtcm_frames = host.get("rtcm_frames", [])
    rx._last_rtcm_ms = int(host.get("last_rtcm_ms", 0))
    rx._last_reacq_ms = int(host.get("last_reacq_ms", 0))
    rx._flip_hist = host.get("flip_hist")
    rx._flip_hist_ms = int(host.get("flip_hist_ms", 0))
    rx._flip_prev_sign = host.get("flip_prev_sign")
    if host.get("aided_low_conf") is not None:
        rx._aided_low_conf = host["aided_low_conf"]
    if host.get("pending_phase") is not None:
        rx._pending_phase = host["pending_phase"]
    if host.get("pending_cnt") is not None:
        rx._pending_cnt = host["pending_cnt"]
    rx._phase_ref_prn = int(host.get("phase_ref_prn", 0))
    if "code_table" in data:
        rx.code_table = jnp.asarray(data["code_table"])
        rx.track_state = TrackState(
            **{
                f: jnp.asarray(data[f"ts_{f}"])
                for f in TrackState._fields
            }
        )
    return rx
