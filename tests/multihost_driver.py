"""Subprocess driver for the real 2-process DCN test (tests/test_multihost.py).

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize`` wires
them into one 8-device cluster over the loopback "DCN". The (cpi=2, ch=2,
rng=2) pod mesh then spans both processes on its cpi axis — the layout
``parallel.multihost`` prescribes (time blocks across hosts, halos inside).

Writes this process's addressable output shards (+ their global indices) to an
npz for the parent test to compare against the unsharded single-process chain.
"""

import os
import sys


def _setup(port, pid):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from rsp_chains.parallel.multihost import initialize_cluster

    initialize_cluster(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    return jax


def main():
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "oneshot"
    if mode == "stream":
        return main_stream(port, pid, outdir)
    jax = _setup(port, pid)

    import numpy as np
    import jax.numpy as jnp

    from rsp_chains import (
        CfarConfig, ChainConfig, FftConfig, RuntimeConfig, fft_mag_cfar_chain,
    )
    from rsp_chains.cplx import C
    from rsp_chains.golden import three_tone_signal
    from rsp_chains.parallel.multihost import (
        make_pod_mesh, pod_spec, shard_cpi_stream,
    )

    mesh = make_pod_mesh(time_blocks=2, channels=2, range_shards=2)
    # small elaboration (256-pt, w<=16): the pod path's correctness claim is
    # shape-independent, and the 1024-pt XLA CPU compile alone took 2-4 min
    # per restart on a loaded machine — the r5 full-matrix flake
    cfg = ChainConfig(
        fft=FftConfig(max_size=256),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=8),
    )
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5,
                            div_sum=3)
    # host numpy register values are valid fully-replicated inputs on every
    # process; device-committed scalars would be process-local
    rt = jax.tree_util.tree_map(np.asarray, rt)

    iq = np.stack([
        np.stack([three_tone_signal(256, shift_range_factor=3, seed=s + 10 * t)
                  for s in range(2)])
        for t in range(2)
    ]).astype(np.complex64)  # [T=2, C=2, N=256] — same on both processes
    re = np.ascontiguousarray(iq.real.astype(np.float32))
    im = np.ascontiguousarray(iq.imag.astype(np.float32))

    sharding = jax.sharding.NamedSharding(mesh, pod_spec(batch_axes=1))
    mk = lambda a: jax.make_array_from_callback(
        a.shape, sharding, lambda idx: a[idx])
    x = C(mk(re), mk(im))

    run = shard_cpi_stream(chain.__call__, mesh)
    out = run(x, rt)
    thr = out.threshold
    pk = out.peaks

    shards = {}
    for i, s in enumerate(thr.addressable_shards):
        shards[f"thr_{i}"] = np.asarray(s.data)
        shards[f"idx_{i}"] = np.array(
            [[d.start or 0, d.stop if d.stop is not None else dim]
             for d, dim in zip(s.index, thr.shape)], np.int64)
    for i, s in enumerate(pk.addressable_shards):
        shards[f"pk_{i}"] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), **shards)
    jax.distributed.shutdown()


def _shards_of(arr, prefix, store):
    import numpy as np

    for i, s in enumerate(arr.addressable_shards):
        store[f"{prefix}_{i}"] = np.asarray(s.data)
        store[f"{prefix}_idx_{i}"] = np.array(
            [[d.start or 0, d.stop if d.stop is not None else dim]
             for d, dim in zip(s.index, arr.shape)], np.int64)


def main_stream(port, pid, outdir):
    """BASELINE config 5 end to end: continuous multi-CPI streaming through
    the pod pipeline on 2 processes, with a register write + checkpoint after
    CPI 2 and a RESTORED pipeline finishing CPIs 3-5."""
    jax = _setup(port, pid)

    import dataclasses
    import time

    import numpy as np

    from rsp_chains import (
        CfarConfig, ChainConfig, FftConfig, RuntimeConfig, fft_mag_cfar_chain,
    )
    from rsp_chains.golden import three_tone_signal
    from rsp_chains.io.cpi import load_state
    from rsp_chains.parallel.multihost import (
        PodStreamingPipeline, make_pod_mesh,
    )

    mesh = make_pod_mesh(time_blocks=2, channels=2, range_shards=2)
    cfg = ChainConfig(
        fft=FftConfig(max_size=256),
        cfar=CfarConfig(max_ref_window=16, max_guard_window=8),
    )
    chain = fft_mag_cfar_chain(cfg)
    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=3.5,
                            div_sum=3)
    rt = jax.tree_util.tree_map(np.asarray, rt)

    n_cpis = 6
    cpis = []
    for seq in range(n_cpis):
        iq = np.stack([
            np.stack([three_tone_signal(256, shift_range_factor=3,
                                        seed=100 * seq + s + 10 * t)
                      for s in range(2)])
            for t in range(2)
        ]).astype(np.complex64)           # [T=2, C=2, N] — same on both procs
        cpis.append(iq)

    store = {}
    dets = np.full(n_cpis, -1, np.int64)

    def on_result(seq, out, m):
        _shards_of(out.threshold, f"thr{seq}", store)
        _shards_of(out.peaks, f"pk{seq}", store)
        dets[seq] = m.detections          # GLOBAL count (pod-array reduction)

    def wait_out(pipe, k, budget=180):
        t0 = time.time()
        while pipe.stats.frames_out < k:
            if time.time() - t0 > budget:
                raise TimeoutError(
                    f"proc{pid}: {pipe.stats.frames_out}/{k} CPIs drained")
            time.sleep(0.02)

    pipe = PodStreamingPipeline(chain.__call__, rt, mesh, on_result=on_result)
    pipe.start()
    for seq in range(3):
        assert pipe.submit(seq, cpis[seq])
    wait_out(pipe, 3)

    # mid-stream register write, then checkpoint (register file + cursor);
    # every process checkpoints its own (identical) copy
    rt_hot = dataclasses.replace(rt, threshold_scaler=np.float32(5.0))
    pipe.reconfigure(rt_hot)
    ck = os.path.join(outdir, f"ckpt{pid}")
    pipe.checkpoint(ck, next_seq=np.int64(3))
    pipe.stop()

    # --- restart: a NEW pipeline resumes from the checkpointed state ---
    rt_restored, extras = load_state(ck)
    rt_restored = jax.tree_util.tree_map(np.asarray, rt_restored)
    assert float(rt_restored.threshold_scaler) == 5.0
    next_seq = int(extras["next_seq"])
    assert next_seq == 3

    pipe2 = PodStreamingPipeline(chain.__call__, rt_restored, mesh,
                                 on_result=on_result)
    pipe2.start()
    for seq in range(next_seq, n_cpis):
        assert pipe2.submit(seq, cpis[seq])
    wait_out(pipe2, n_cpis - next_seq)
    pipe2.stop()

    assert pipe.stats.frames_out + pipe2.stats.frames_out == n_cpis
    assert pipe.stats.frames_failed == 0 and pipe2.stats.frames_failed == 0
    store["detections"] = dets
    np.savez(os.path.join(outdir, f"stream_proc{pid}.npz"), **store)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
