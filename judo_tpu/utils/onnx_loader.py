"""Python side of the native ONNX extractor: load weights, build a JAX MLP.

The reference runs the Spot locomotion policy with ONNX Runtime inside C++
threads (mujoco_extensions/onnx_interface). Here the network is extracted
once by the native parser (native/onnx_extract.cpp, built with `make -C
native`) and re-expressed as a pure-JAX MLP that jits straight into the
rollout — per SURVEY §2.4's equivalents mapping.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libonnx_extract.so"

_ONNX_DTYPES = {1: np.float32, 7: np.int64, 11: np.float64}


class OnnxGraph(NamedTuple):
    tensors: dict[str, np.ndarray]
    nodes: list[tuple[str, list[str], list[str]]]  # (op_type, inputs, outputs)


def _ensure_native_built() -> Path:
    if not _LIB_PATH.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True)
    return _LIB_PATH


def extract_onnx(onnx_path: str | Path, out_path: str | Path | None = None) -> OnnxGraph:
    """Run the native extractor and parse its container."""
    onnx_path = Path(onnx_path)
    if out_path is None:
        out_path = onnx_path.with_suffix(".jtw")
    lib = ctypes.CDLL(str(_ensure_native_built()))
    lib.onnx_extract.restype = ctypes.c_int
    rc = lib.onnx_extract(str(onnx_path).encode(), str(out_path).encode())
    if rc != 0:
        raise RuntimeError(f"onnx_extract failed with code {rc} for {onnx_path}")
    return _read_container(out_path)


def _read_container(path: str | Path) -> OnnxGraph:
    data = Path(path).read_bytes()
    assert data[:8] == b"JTONNX1\0", "bad container magic"
    off = 8

    def u32():
        nonlocal off
        v = struct.unpack_from("<I", data, off)[0]
        off += 4
        return v

    def u64():
        nonlocal off
        v = struct.unpack_from("<Q", data, off)[0]
        off += 8
        return v

    def s():
        nonlocal off
        n = u32()
        v = data[off : off + n].decode()
        off += n
        return v

    tensors: dict[str, np.ndarray] = {}
    for _ in range(u32()):
        name = s()
        dtype = u32()
        ndims = u32()
        dims = [u64() for _ in range(ndims)]
        nbytes = u64()
        raw = data[off : off + nbytes]
        off += nbytes
        np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
        tensors[name] = np.frombuffer(raw, dtype=np_dtype).reshape(dims).copy()

    nodes = []
    for _ in range(u32()):
        op = s()
        ins = [s() for _ in range(u32())]
        outs = [s() for _ in range(u32())]
        nodes.append((op, ins, outs))
    return OnnxGraph(tensors=tensors, nodes=nodes)


_ACTIVATIONS = {
    "Relu": lambda x: jnp.maximum(x, 0.0),
    "Elu": lambda x: jnp.where(x > 0, x, jnp.expm1(x)),
    "Tanh": jnp.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + jnp.exp(-x)),
    "LeakyRelu": lambda x: jnp.where(x > 0, x, 0.01 * x),
    "Softsign": lambda x: x / (1.0 + jnp.abs(x)),
    "Identity": lambda x: x,
}


class MLPPolicy(NamedTuple):
    """Feed-forward policy compiled from an ONNX Gemm/activation chain."""

    weights: tuple  # ((W, b), ...) jnp arrays, W shape (in, out)
    activations: tuple  # activation name per layer ("" for none)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        for (w, b), act in zip(self.weights, self.activations):
            x = x @ w + b
            if act:
                x = _ACTIVATIONS[act](x)
        return x

    @property
    def input_dim(self) -> int:
        return self.weights[0][0].shape[0]

    @property
    def output_dim(self) -> int:
        return self.weights[-1][0].shape[1]


def mlp_from_onnx(onnx_path: str | Path, dtype=jnp.float32) -> MLPPolicy:
    """Lower a Gemm/activation ONNX chain into an MLPPolicy.

    Accepts either a raw ``.onnx`` (extracted by the native parser) or an
    already-extracted ``.jtw`` container (the vendored form shipped in
    judo_tpu/models/policies/, so the repo runs standalone without the
    reference checkout or the native toolchain).
    """
    onnx_path = Path(onnx_path)
    if onnx_path.suffix == ".jtw":
        graph = _read_container(onnx_path)
    else:
        graph = extract_onnx(onnx_path)
    layers: list[tuple[np.ndarray, np.ndarray]] = []
    acts: list[str] = []
    for op, ins, _outs in graph.nodes:
        if op == "Gemm":
            w_name = next(i for i in ins if "weight" in i)
            b_name = next(i for i in ins if "bias" in i)
            w = graph.tensors[w_name]
            b = graph.tensors[b_name]
            layers.append((w.T, b))  # pytorch Gemm uses transB: out = x W^T + b
            acts.append("")
        elif op in _ACTIVATIONS:
            if not layers:
                raise ValueError(f"activation {op} before any Gemm")
            acts[-1] = op
        elif op in ("Flatten", "Identity", "Cast"):
            continue
        else:
            raise NotImplementedError(f"unsupported ONNX op in policy: {op}")
    weights = tuple((jnp.asarray(w, dtype), jnp.asarray(b, dtype)) for w, b in layers)
    return MLPPolicy(weights=weights, activations=tuple(acts))
