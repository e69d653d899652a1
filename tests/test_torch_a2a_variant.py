"""The rule that picks the block-copy kernel's instance, and the launch path
the kernel wrappers share, on the CPU.

``a2a_pack.variant`` sends every exchange the served models make to a
16-byte instance: megatron-moe-32e with EP over (pod, data) and mixtral-8x7b
with EP over pod alone, each at the prefill and the decode capacity of 32
requests on the (2, 16) local mesh (128-token prompts for megatron, 1024
for mixtral), in bf16 rows, mixtral's int8 rows and f32 scale rows of width
1, and f32 rows as the f32 checks exchange them.  Mixtral's prefill
exchanges, from 512 MiB moved, take ``bulk``; the rest, ``vec``.  Blocks
whose size or pointers are off 16-byte alignment go to ``bytes``.  Once a
kernel's library is loaded, ``_build.load`` takes no lock and asks nothing
of CUDA; the first load still raises without a device.
"""

import contextlib

import pytest
import torch

from repro_torch import _build
from repro_torch.configs import get_config
from repro_torch.kernels.a2a_pack import (BULK_MIN_BYTES, a2a_pack, a2a_unpack,
                                         variant)
from repro_torch.models.moe import _capacity

MESH = (2, 16)
BATCH = 32
PROMPT = {"megatron-moe-32e": 128, "mixtral-8x7b": 1024}
# EP over (pod, data) puts one slot of i * E_loc * C rows in a block; EP
# over pod alone, E_loc * C rows
FAST_EP = {"megatron-moe-32e": True, "mixtral-8x7b": False}
N_BLOCKS = 64   # 32 ranks x 2 pods packed; 32 ranks x 2 slots unpacked
ELEM = {"bf16": 2, "int8": 1, "f32": 4}
# (arch, phase, dtype, row width, the instance the rule must pick)
SERVING = [
    ("megatron-moe-32e", "prefill", "bf16", "d_model", "vec"),   # 96 MiB
    ("megatron-moe-32e", "prefill", "f32", "d_model", "vec"),    # 192 MiB
    ("megatron-moe-32e", "decode", "bf16", "d_model", "vec"),    # 32 MiB
    ("megatron-moe-32e", "decode", "f32", "d_model", "vec"),     # 64 MiB
    ("mixtral-8x7b", "prefill", "bf16", "d_model", "bulk"),      # 1280 MiB
    ("mixtral-8x7b", "prefill", "int8", "d_model", "bulk"),      # 640 MiB
    ("mixtral-8x7b", "prefill", "f32", 1, "vec"),                # 640 KiB
    ("mixtral-8x7b", "prefill", "f32", "d_model", "bulk"),       # 2560 MiB
    ("mixtral-8x7b", "decode", "bf16", "d_model", "vec"),        # 16 MiB
    ("mixtral-8x7b", "decode", "int8", "d_model", "vec"),        # 8 MiB
    ("mixtral-8x7b", "decode", "f32", 1, "vec"),                 # 8 KiB
    ("mixtral-8x7b", "decode", "f32", "d_model", "vec"),         # 32 MiB
]


def _block_bytes(arch, phase, dt, width):
    """Bytes of one exchange block, as chip_smoke.py computes its rows."""
    cfg = get_config(arch)
    p, i = MESH
    n_ranks = p * i
    e = cfg.moe.num_experts
    e_loc = e // (n_ranks if FAST_EP[arch] else p)
    t = BATCH // n_ranks * (PROMPT[arch] if phase == "prefill" else 1)
    rows = (i if FAST_EP[arch] else 1) * e_loc * _capacity(cfg, t, e)
    d = cfg.d_model if width == "d_model" else width
    return rows * d * ELEM[dt]


@pytest.mark.parametrize("arch,phase,dt,width,want", SERVING)
def test_every_serving_exchange_takes_a_16_byte_instance(arch, phase, dt,
                                                         width, want):
    """Allocations lie on at least 256 bytes, so each exchange's pack and
    unpack (fresh inputs and outputs) take the 16-byte paths: bulk from
    512 MiB moved, vec below."""
    block_bytes = _block_bytes(arch, phase, dt, width)
    assert block_bytes % 16 == 0
    assert (N_BLOCKS * block_bytes >= BULK_MIN_BYTES) == (want == "bulk")
    for src, dst in ((0, 0), (1 << 20, 3 << 21), (512, 1 << 30)):
        assert variant(block_bytes, N_BLOCKS, src, dst) == want


def test_bulk_threshold():
    assert variant(16, BULK_MIN_BYTES // 16, 0, 0) == "bulk"
    assert variant(16, BULK_MIN_BYTES // 16 - 1, 0, 0) == "vec"
    assert variant(BULK_MIN_BYTES, 1, 0, 0) == "bulk"


def test_serving_block_sizes():
    """The blocks the rule sees: megatron's decode slot is 128 rows of
    2048 bf16 (512 KiB), mixtral's 32 rows of 4096, its scale rows 128
    bytes."""
    assert _block_bytes("megatron-moe-32e", "decode", "bf16",
                        "d_model") == 128 * 2048 * 2
    assert _block_bytes("megatron-moe-32e", "prefill", "bf16",
                        "d_model") == 384 * 2048 * 2
    assert _block_bytes("mixtral-8x7b", "decode", "bf16",
                        "d_model") == 32 * 4096 * 2
    assert _block_bytes("mixtral-8x7b", "prefill", "int8",
                        "d_model") == 2560 * 4096
    assert _block_bytes("mixtral-8x7b", "decode", "f32", 1) == 32 * 4


@pytest.mark.parametrize("dt,d,rows", [("bf16", 5, 1), ("bf16", 5, 3),
                                       ("f32", 1, 3), ("int8", 1, 1),
                                       ("int8", 130, 1)])
def test_unaligned_blocks_take_bytes(dt, d, rows):
    for n_blocks in (1, 64, 1 << 30):
        assert variant(rows * d * ELEM[dt], n_blocks, 0, 0) == "bytes"


@pytest.mark.parametrize("src,dst", [(8, 0), (0, 4), (2, 2), (1 << 20 | 1,
                                                             1 << 21)])
def test_unaligned_pointers_take_bytes(src, dst):
    for n_blocks in (64, 1 << 20):
        assert variant(128 * 2048 * 2, n_blocks, src, dst) == "bytes"


def test_cpu_tensors_count_no_launch(monkeypatch):
    """A CPU tensor takes the plain version: no build, no launch, and no
    instance's count moves."""
    def no_build(name):
        raise AssertionError(f"CPU tensors must not load {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = [(f.launches, dict(f.launches_by_variant))
              for f in (a2a_pack, a2a_unpack)]
    assert set(before[0][1]) == {"bulk", "vec", "bytes"}
    x = torch.arange(64, dtype=torch.bfloat16).reshape(8, 8)
    idx = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    packed = a2a_pack(x, idx, block_rows=2)
    assert torch.equal(a2a_unpack(packed, idx, block_rows=2), x)
    assert [(f.launches, dict(f.launches_by_variant))
            for f in (a2a_pack, a2a_unpack)] == before


def test_first_load_raises_without_cuda(monkeypatch):
    """The lock-free fast path serves only loaded libraries: the first load
    of a kernel still asks for a device and raises without one."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("a2a_block_copy", "grouped_matmul", "flash_attention"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name)


def test_loaded_library_takes_no_lock(monkeypatch):
    """A loaded library comes back from one dictionary read: no lock, no
    device query."""
    class Refuse:
        def __enter__(self):
            raise AssertionError("the fast path took the lock")

        def __exit__(self, *exc):
            return False

    def no_query():
        raise AssertionError("the fast path asked for a device")

    lib = object()
    monkeypatch.setattr(_build, "_libs", {"a2a_block_copy": lib})
    monkeypatch.setattr(_build, "_lock", Refuse())
    monkeypatch.setattr(_build, "_require_cuda", no_query)
    assert _build.load("a2a_block_copy") is lib


@pytest.mark.parametrize("current", [0, 1])
def test_launch_switches_device_only_when_needed(monkeypatch, current):
    """``_build.launch`` passes the current stream's raw handle last and
    enters ``torch.cuda.device`` only for a tensor on another device."""
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 1000 + index)
    calls = []
    rc = _build.launch(lambda *a: calls.append(a) or 0,
                       torch.device("cuda", 0), 7, 8)
    assert rc == 0 and calls == [(7, 8, 1000)]
    assert entered == ([] if current == 0 else [0])
