"""The NVMe optimizer tier of the port on the CPU: ``ops/aio`` over the
repo's ``csrc/aio/ds_aio.cpp`` (built by ``ops/op_builder/builder.py``'s
``AsyncIOBuilder``), ``runtime/swap_tensor/*``,
``runtime/zero/contiguous_memory_allocator.py`` and the engine's
``offload_optimizer: {"device": "nvme"}``, against the JAX package.

Twins of ``tests/test_native_ops.py:23-103`` (the handle's accessors,
sync / async / offset round trips, a missing file, every submission
mode), ``tests/test_memory_allocator.py`` and
``tests/test_offload.py:262-320`` (NVMe against the CPU tier, pipelined
against synchronous, the parameter swapper and the async swapper).  On
gpt2-tiny in fp32 (graded config 3's training config at gas 2, remat,
three sub-groups) the NVMe tier equals the port's CPU tier bit for bit in
losses, master, moments and params (the same native step on the same
bytes; the files only hold them), the pipelined swapper equals the
synchronous one bit for bit, and the port matches the JAX NVMe engine
within 1e-5 (the JAX test's tolerance; another order of fp32 sums in the
gradients).  Swap directories (JAX's layout,
``zero_stage_optimizer/rank0/group<g>_<name>.swp``) and checkpoints cross
the packages both ways.  g++ is present wherever the port runs its
offload tier, so nothing here skips on the toolchain."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.aio import AsyncIOHandle as JAsyncIOHandle
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.swap_tensor.partitioned_optimizer_swapper import (
    PartitionedOptimizerSwapper as JSwapper)
from deepspeed_tpu.runtime.zero.contiguous_memory_allocator import (
    ContiguousMemoryAllocator as JAllocator)

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import fault
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aio_available
from deepspeed_tpu_torch.ops.op_builder.builder import AsyncIOBuilder, CSRC_DIR
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.swap_tensor import utils as su
from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper import (
    PartitionedOptimizerSwapper, PipelinedOptimizerSwapper)
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    AsyncPartitionedParameterSwapper)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroOffloadOptimizerConfig
from deepspeed_tpu_torch.runtime.zero.contiguous_memory_allocator import (
    ContiguousMemoryAllocator)
from deepspeed_tpu_torch.runtime.utils import tree_leaves

LOSS_RTOL = 1e-5
MOMENT_RTOL = 1e-4          # |port - JAX| / |JAX| over a whole moment buffer
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)
GATE = np.ones((48,), np.float32)
SUB_GROUP = 400000          # gpt2-tiny's 928512 parameters in three groups
STEPS = 3
MOMENTS = ("exp_avg", "exp_avg_sq")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# aio (test_native_ops.py:23-103)
# ---------------------------------------------------------------------------
def test_aio_builder_builds_the_repo_source():
    """The library is ``csrc/aio/ds_aio.cpp`` as it is, built at first use
    with JAX's flags and ``-pthread``; the handle types its C ABI."""
    b = AsyncIOBuilder()
    assert aio_available()
    assert b.sources() == [CSRC_DIR / "aio" / "ds_aio.cpp"]
    assert b.cflags() == ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
    lib = b.load()
    assert b.lib_path().is_file() and lib.dsaio_create.restype is not None


def test_aio_handle_accessors():
    h = AsyncIOHandle(block_size=4096, queue_depth=16, single_submit=True,
                      overlap_events=True, thread_count=2)
    assert h.get_block_size() == 4096 and h.get_queue_depth() == 16
    assert h.get_single_submit() is True and h.get_overlap_events() is True
    assert h.get_thread_count() == 2 and h.pending_count() == 0


@pytest.mark.parametrize("nbytes", [13, 4096, 1 << 20])
def test_aio_sync_roundtrip(tmp_path, nbytes):
    """A round trip, and JAX's handle reads the port's file back."""
    h = AsyncIOHandle(block_size=4096, thread_count=4)
    src = torch.from_numpy(np.random.default_rng(nbytes).integers(0, 256, nbytes, np.uint8))
    path = str(tmp_path / "swap.bin")
    assert h.sync_pwrite(src, path) == nbytes
    dst = torch.zeros(nbytes, dtype=torch.uint8)
    assert h.sync_pread(dst, path) == nbytes
    assert torch.equal(src, dst)
    other = np.zeros(nbytes, np.uint8)
    assert JAsyncIOHandle().sync_pread(other, path) == nbytes
    np.testing.assert_array_equal(other, src.numpy())


def test_aio_async_roundtrip(tmp_path):
    h = AsyncIOHandle(block_size=1 << 16, thread_count=4)
    bufs = [torch.rand(1 << 14) for _ in range(4)]
    paths = [str(tmp_path / f"t{i}.bin") for i in range(4)]
    for b, p in zip(bufs, paths):
        h.async_pwrite(b, p)
    assert h.pending_count() == 4 and len(h._inflight) == 4
    assert h.wait() == 4 and not h._inflight
    outs = [torch.zeros_like(b) for b in bufs]
    for o, p in zip(outs, paths):
        h.async_pread(o, p)
    assert h.wait() == 4
    assert all(torch.equal(b, o) for b, o in zip(bufs, outs))


def test_aio_read_at_offset(tmp_path):
    h = AsyncIOHandle()
    path = str(tmp_path / "off.bin")
    JAsyncIOHandle().sync_pwrite(np.arange(1000, dtype=np.float32), path)
    dst = torch.zeros(100)
    h.sync_pread(dst, path, offset=400)      # 100 floats from element 100
    assert torch.equal(dst, torch.arange(100, 200, dtype=torch.float32))


def test_aio_missing_file_and_bad_buffers_raise(tmp_path):
    h = AsyncIOHandle()
    with pytest.raises(OSError):
        h.sync_pread(torch.zeros(8, dtype=torch.uint8), str(tmp_path / "nope.bin"))
    with pytest.raises(ValueError):
        h.sync_pwrite(torch.zeros(8, 8).t(), str(tmp_path / "x.bin"))
    with pytest.raises(TypeError):
        h.sync_pwrite(np.zeros(8), str(tmp_path / "x.bin"))


@pytest.mark.parametrize("single_submit", [0, 1])
@pytest.mark.parametrize("overlap_events", [0, 1])
def test_aio_submission_semantics_roundtrip(tmp_path, single_submit, overlap_events):
    """Every (single_submit, overlap_events) mode moves the bytes exactly,
    a tail shorter than the block and an aligned size, from an aligned
    buffer and from an unaligned one."""
    h = AsyncIOHandle(block_size=4096, queue_depth=4, single_submit=bool(single_submit),
                      overlap_events=bool(overlap_events))
    for nbytes in (4096 * 4, 4096 * 3 + 777):
        data = torch.from_numpy(np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                                        np.uint8))
        for src in (su.aligned_empty(nbytes, torch.uint8)[:nbytes], data[1:].clone()):
            src.copy_(data[:src.numel()])
            path = str(tmp_path / f"t{single_submit}{overlap_events}_{nbytes}.bin")
            assert h.sync_pwrite(src, path) == src.numel()
            out = torch.zeros_like(src)
            assert h.sync_pread(out, path) == src.numel()
            assert torch.equal(out, src)


def test_aligned_buffers_and_sizes(tmp_path):
    """Swap buffers start on a 4096-byte boundary and hold a multiple of
    4096 bytes; a JAX-written file of the exact size reads its own bytes."""
    for n in (1, 1000, 1024, 1025, 123457):
        t = su.aligned_empty(n)
        assert su.is_aligned(t) and t.numel() == su.aligned_numel(n) >= n
        assert t.numel() * 4 % su.AIO_ALIGNED_BYTES == 0 and not t.any()
    assert su.swappable_numel(1 << 18) and not su.swappable_numel(1000)
    path = str(tmp_path / "j.swp")
    JAsyncIOHandle().sync_pwrite(np.ones(1000, np.float32), path)
    assert su.aligned_read_bytes(path, 1000) == 4000
    AsyncIOHandle().sync_pwrite(su.aligned_empty(1000), path)
    assert su.aligned_read_bytes(path, 1000) == 4096
    with pytest.raises(OSError):
        su.aligned_read_bytes(path, 2000)


# ---------------------------------------------------------------------------
# the host arena (test_memory_allocator.py)
# ---------------------------------------------------------------------------
def _arena_ops(alloc_cls, fill):
    """One sequence of allocations, releases, a defragmenting request and
    writes; returns the addresses, the free map and the contents."""
    a = alloc_cls(100)
    ids = []
    for i in range(5):
        tid, v = a.allocate_tensor(20)
        fill(v, float(i))
        ids.append(tid)
    a.release_tensor(ids[1])
    a.release_tensor(ids[3])
    tid, v = a.allocate_tensor(40)          # fits no hole: defragments
    fill(v, 9.0)
    contents = {t: np.asarray(a.get_tensor(t)).copy() for t in (ids[0], ids[2], ids[4], tid)}
    return dict(a.tensor_addresses), dict(a.contiguous_sizes), a.total_free, contents


def test_arena_matches_jax_and_defrag_keeps_contents():
    def fill_t(v, x):
        v.fill_(x)

    def fill_j(v, x):
        v[:] = x
    got, want = _arena_ops(ContiguousMemoryAllocator, fill_t), _arena_ops(JAllocator, fill_j)
    assert got[:3] == want[:3] and got[2] == 0
    for t in want[3]:
        np.testing.assert_array_equal(got[3][t], want[3][t])
    assert [float(got[3][t][0]) for t in sorted(got[3])] == [0.0, 2.0, 4.0, 9.0]


def test_arena_roundtrip_merge_overcommit_and_map():
    a = ContiguousMemoryAllocator(100)
    t1, v1 = a.allocate_tensor(30)
    t2, v2 = a.allocate_tensor(50)
    v1.fill_(1.0)
    v2.fill_(2.0)
    a.release_tensor(t1)
    assert a.total_free == 50
    a.allocate_tensor(25)
    assert torch.all(a.get_tensor(t2) == 2.0)
    b = ContiguousMemoryAllocator(60)
    ids = [b.allocate_tensor(20)[0] for _ in range(3)]
    b.release_tensor(ids[0])
    b.release_tensor(ids[1])
    assert b._largest_free() == 40          # adjacent free blocks merged
    b.allocate_tensor(40)
    with pytest.raises(MemoryError):        # JAX: AssertionError
        b.allocate_tensor(1)
    c = ContiguousMemoryAllocator(100)
    c.allocate_tensor(50)
    line = c.print_allocation(resolution=10)
    assert "x" in line and "." in line


# ---------------------------------------------------------------------------
# swappers (test_offload.py:300-320)
# ---------------------------------------------------------------------------
def test_param_swapper_roundtrip(tmp_path):
    sw = AsyncPartitionedParameterSwapper({}, str(tmp_path), buffer_count=3, buffer_numel=4096)
    rng = np.random.default_rng(0)
    arrays = {i: torch.from_numpy(rng.random(1000 + i, np.float32)) for i in range(5)}
    for pid, arr in arrays.items():
        sw.swap_out(pid, arr)
    sw.synchronize_writes()
    assert sw.available_swap_in_buffers() == 3
    assert sorted(os.listdir(tmp_path / "zero_stage_3" / "float32params" / "rank0")) == \
        [f"param_{i}.swp" for i in range(5)]
    sw.swap_in([0, 1], async_op=False)
    assert torch.equal(sw.get_buffer(0), arrays[0]) and torch.equal(sw.get_buffer(1), arrays[1])
    sw.release([0, 1])
    sw.swap_in([4], async_op=True)
    with pytest.raises(RuntimeError):
        sw.get_buffer(4)                    # the read is not synchronized yet
    sw.synchronize_reads()
    assert torch.equal(sw.get_buffer(4), arrays[4])
    with pytest.raises(ValueError):
        sw.swap_out(9, torch.zeros(5000))


def test_async_tensor_swapper(tmp_path):
    sw = AsyncTensorSwapper(AsyncIOHandle(thread_count=2), buffer_count=2)
    tensors = [torch.rand(512) for _ in range(6)]
    paths = [str(tmp_path / f"x{i}.swp") for i in range(6)]
    sw.add_buffers(tensors, paths)          # 6 writes through 2 buffers: drains between
    sw.flush()
    assert sw.swapped_bytes == sum(t.numel() * 4 for t in tensors)
    h = JAsyncIOHandle()
    for t, p in zip(tensors, paths):
        out = np.zeros(512, np.float32)
        h.sync_pread(out, p)                # JAX reads the port's (aligned) files
        np.testing.assert_array_equal(out, t.numpy())
    sw.release_buffers()


def _off_cfg(pipe=False, buffer_count=4):
    return DeepSpeedZeroOffloadOptimizerConfig(
        {"device": "nvme", "nvme_path": "unused", "buffer_count": buffer_count,
         "pipeline_read": pipe})


@pytest.mark.parametrize("pipe", [False, True])
def test_optimizer_swap_directory_crosses_jax(tmp_path, pipe):
    """The port's swapper writes JAX's layout, and JAX's swapper reads it;
    JAX's files (their exact size) read back in the port.  The pipelined
    swapper's prefetch returns the group's data."""
    rng = np.random.default_rng(1)
    groups = [{n: rng.random(k, np.float32) for n in MOMENTS} for k in (5000, 3001, 77)]
    cls = PipelinedOptimizerSwapper if pipe else PartitionedOptimizerSwapper
    sw = cls(_off_cfg(pipe), {}, str(tmp_path / "port"), buffer_numel=5000)
    assert sw.slots == (3 if pipe else 2)
    for g, t in enumerate(groups):
        sw.swap_out_group(g, {n: torch.from_numpy(a) for n, a in t.items()})
    sw.wait()
    folder = tmp_path / "port" / "zero_stage_optimizer" / "rank0"
    assert sorted(os.listdir(folder)) == sorted(f"group{g}_{n}.swp" for g in range(3)
                                                for n in MOMENTS)
    js = JSwapper(None, {}, str(tmp_path / "port"))
    for g, t in enumerate(groups):
        for n, a in t.items():
            js._numel[(g, n)] = a.size
        got = js.swap_in_group(g, MOMENTS)
        for n in MOMENTS:
            np.testing.assert_array_equal(got[n], t[n])
    jw = JSwapper(None, {}, str(tmp_path / "jax"))
    for g, t in enumerate(groups):
        jw.swap_out_group(g, t)
    back = cls(_off_cfg(pipe), {}, str(tmp_path / "jax"), buffer_numel=5000)
    for g, t in enumerate(groups):
        for n, a in t.items():
            back.set_numel(g, n, a.size)
    if pipe:
        back.prefetch_group(0, MOMENTS)
    for g, t in enumerate(groups):
        got = back.get_group(g, MOMENTS) if pipe else back.swap_in_group(g, MOMENTS)
        if pipe and g + 1 < len(groups):
            back.prefetch_group(g + 1, MOMENTS)
        for n in MOMENTS:
            np.testing.assert_array_equal(got[n].numpy(), t[n])
        assert su.is_aligned(back._bufs[back._slot(g)][MOMENTS[0]].data)


# ---------------------------------------------------------------------------
# the engine's NVMe tier on gpt2-tiny (test_offload.py:262-296)
# ---------------------------------------------------------------------------
def _cfg(path=None, pipe=False, dpu=None, **over):
    off = {"device": "cpu"} if path is None else {
        "device": "nvme", "nvme_path": str(path), "pipeline_read": pipe, "pipeline_write": pipe}
    if dpu is not None:
        off.update(delayed_param_update=True, delayed_param_update_warmup=dpu)
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}},
           "zero_optimization": {"stage": 3, "sub_group_size": SUB_GROUP,
                                 "offload_optimizer": off}}
    cfg.update(over)
    return cfg


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _port(cfg, gated=False):
    m = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32, remat=True,
             **NO_DROPOUT)
    if not gated:
        return tds.initialize(config=cfg, model=m, params=_np_params(0),
                              training_data=(TOKENS,))[0]
    # a float leaf for fault.corrupt_batch's grad_nan: the loss times its mean (1.0)
    return tds.initialize(config=cfg, model=m, params=_np_params(0), training_data=(TOKENS, GATE),
                          loss_fn=lambda p, b, r: m.loss(p, b[0], r) * b[1].mean())[0]


def _state(e):
    m, v = e._offload.moments()
    return {"master": e._offload.master.copy(), "m": m.copy(), "v": v.copy(),
            "params": [t.clone() for t in tree_leaves(e.params)]}


def _same_state(a, b):
    for k in ("master", "m", "v"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))


def _swap_bytes(path):
    folder = os.path.join(path, "zero_stage_optimizer", "rank0")
    return {f: open(os.path.join(folder, f), "rb").read() for f in sorted(os.listdir(folder))}


@pytest.fixture(scope="module")
def cpu_tier():
    """The port's CPU tier: its losses and state after STEPS steps."""
    e = _port(_cfg())
    return [float(e.train_batch()) for _ in range(STEPS)], _state(e)


@pytest.fixture(scope="module")
def jax_nvme(tmp_path_factory):
    """The JAX NVMe engine on a 1-device mesh (compile cache off): STEPS
    steps, then a checkpoint."""
    path = tmp_path_factory.mktemp("jax_nvme")
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, remat=True, **NO_DROPOUT)
    je = jds.initialize(config=dict(_cfg(path / "swap"), compile_cache={"enabled": False}),
                        model=jm, params=_np_params(0), training_data=(TOKENS,),
                        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    assert je._offload.nvme and len(je._offload.sub_groups) == 3
    losses = [float(je.train_batch()) for _ in range(STEPS)]
    je.save_checkpoint(str(path / "ckpt"))
    return {"engine": je, "losses": losses, "path": path}


@pytest.mark.parametrize("pipe", [False, True])
def test_nvme_equals_cpu_tier_bit_for_bit(cpu_tier, tmp_path, pipe):
    """``test_nvme_offload_loss_matches_cpu`` / ``_pipelined_matches_sync``
    held bit for bit: losses, master, moments (gathered from the files) and
    params; the moments live in JAX's layout on disk, in aligned files."""
    e = _port(_cfg(tmp_path, pipe=pipe))
    off = e._offload
    assert off.nvme and off.m is None and len(off.sub_groups) == 3
    assert type(off.swapper) is (PipelinedOptimizerSwapper if pipe
                                 else PartitionedOptimizerSwapper)
    losses = [float(e.train_batch()) for _ in range(STEPS)]
    assert losses == cpu_tier[0]
    _same_state(_state(e), cpu_tier[1])
    files = _swap_bytes(str(tmp_path))
    assert sorted(files) == sorted(f"group{g}_{n}.swp" for g in range(3) for n in MOMENTS)
    assert all(len(b) % su.AIO_ALIGNED_BYTES == 0 for b in files.values())
    read, written = off.swap_bytes
    assert read == written == sum(len(b) for b in files.values())
    assert set(off.swap_times) == {"swap_in_wait_s", "adam_s", "swap_out_s", "swap_out_wait_s"}


def test_nvme_dpu_equals_cpu_tier_dpu(tmp_path):
    """DPU's host step (on the worker thread) swaps there: the NVMe DPU run
    equals the CPU tier's DPU run bit for bit, its lag included."""
    runs = []
    for cfg in (_cfg(dpu=1), _cfg(tmp_path, pipe=True, dpu=1)):
        e = _port(cfg)
        runs.append(([float(e.train_batch()) for _ in range(STEPS)], _state(e)))
    assert runs[0][0] == runs[1][0]
    _same_state(runs[0][1], runs[1][1])


def test_nvme_matches_jax_nvme_engine(jax_nvme, tmp_path):
    """``test_nvme_offload_loss_matches_cpu`` across the packages: the
    port's NVMe losses within 1e-5 of JAX's NVMe engine and its moments
    within 1e-4 in norm (element by element they carry the gradients'
    fp32 sum order), and JAX's swap files read back in the port bit for
    bit."""
    e = _port(_cfg(tmp_path))
    losses = [float(e.train_batch()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_nvme["losses"], rtol=LOSS_RTOL)
    je = jax_nvme["engine"]
    jm, jv = je._offload.moments()
    m, v = e._offload.moments()
    # element by element the moments carry the gradients' fp32 sum order: held as a whole
    for got, want in ((m, jm), (v, jv)):
        assert np.linalg.norm(got - want) <= MOMENT_RTOL * np.linalg.norm(want)
    sw = PartitionedOptimizerSwapper(_off_cfg(), {}, str(jax_nvme["path"] / "swap"))
    for g, (s, end) in enumerate(je._offload.sub_groups):
        for n, want in zip(MOMENTS, (jm, jv)):
            sw.set_numel(g, n, end - s)
            np.testing.assert_array_equal(sw.swap_in_group(g, (n,))[n].numpy(), want[s:end])


def test_nvme_checkpoints_cross_jax_both_ways(jax_nvme, tmp_path):
    """The JAX NVMe engine's checkpoint loads into the port's NVMe engine
    (master and moments bit-equal, written through the swap files); the
    port's, saved back, loads into the JAX engine bit-equal; the next
    losses agree within 1e-5."""
    je = jax_nvme["engine"]
    e = _port(_cfg(tmp_path / "swap"))
    e.load_checkpoint(str(jax_nvme["path"] / "ckpt"))
    jm, jv = je._offload.moments()
    m, v = e._offload.moments()
    np.testing.assert_array_equal(e._offload.master, je._offload.master)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(v, jv)
    assert e.global_steps == STEPS and e.optimizer_steps == STEPS
    e.save_checkpoint(str(tmp_path / "ckpt"))
    je.load_checkpoint(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(je._offload.moments()[1], v)
    rng = np.random.default_rng(5)
    batches = [[(rng.integers(0, 1024, (4, 33)).astype(np.int32),) for _ in range(2)]
               for _ in range(2)]
    port = [float(e.train_batch(iter(b))) for b in batches]
    jax_ = [float(je.train_batch(iter(b))) for b in batches]
    np.testing.assert_allclose(port, jax_, rtol=LOSS_RTOL)


def test_nvme_checkpoint_roundtrip_with_cpu_tier(cpu_tier, tmp_path):
    """An NVMe checkpoint loads into the CPU tier and back, every leaf
    bit-equal, and the two continue bit-equal."""
    e = _port(_cfg(tmp_path / "a"))
    for _ in range(STEPS):
        e.train_batch()
    e.save_checkpoint(str(tmp_path / "nvme"))
    cpu = _port(_cfg())
    cpu.load_checkpoint(str(tmp_path / "nvme"))
    _same_state(_state(cpu), _state(e))
    cpu.save_checkpoint(str(tmp_path / "cpu"))
    back = _port(_cfg(tmp_path / "b"))
    back.load_checkpoint(str(tmp_path / "cpu"))
    _same_state(_state(back), cpu_tier[1])
    batch = [(TOKENS[:4],), (TOKENS[4:8],)]
    assert float(back.train_batch(iter(batch))) == float(cpu.train_batch(iter(batch)))


def test_nvme_skipped_step_leaves_files_unchanged(tmp_path):
    """A ``grad_nan`` step on the NVMe tier is skipped: master, swap files
    and params bit-unchanged, the skip counted; the next step trains."""
    e = _port(_cfg(tmp_path, pipe=True), gated=True)
    e.train_batch()
    before, files = _state(e), _swap_bytes(str(tmp_path))
    fault.reset()
    try:
        fault.configure("grad_nan=1")
        assert not np.isfinite(float(e.train_batch()))
    finally:
        fault.reset()
    assert e.skipped_steps == 1 and e.optimizer_steps == 1
    _same_state(_state(e), before)
    assert _swap_bytes(str(tmp_path)) == files
    e.train_batch()
    assert e.optimizer_steps == 2 and _swap_bytes(str(tmp_path)) != files


def test_nvme_config_parses_as_jax():
    """``offload_optimizer`` nvme and the ``aio`` block as JAX parses them;
    nvme without ``nvme_path`` raises (JAX asserts in its engine)."""
    pd = {"train_batch_size": 8, "aio": {"block_size": 4096, "thread_count": 2},
          "zero_optimization": {"stage": 3, "offload_optimizer": {
              "device": "nvme", "nvme_path": "/x", "pipeline_read": True}}}
    t, j = DeepSpeedConfig(pd), JConfig(pd, world_size=1)
    assert t.aio_config == j.aio_config
    assert t.zero_config.offload_optimizer.pipeline == j.zero_config.offload_optimizer.pipeline
    assert DeepSpeedConfig({"train_batch_size": 8}).aio_config == JConfig(
        {"train_batch_size": 8}, world_size=1).aio_config
    with pytest.raises(ValueError, match="nvme_path"):
        DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
            "stage": 3, "offload_optimizer": {"device": "nvme"}}})
