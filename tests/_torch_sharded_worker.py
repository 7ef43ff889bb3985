"""One rank of the sharded-path tests (tests/test_torch_sharded.py).

    python tests/_torch_sharded_worker.py TASK.json RANK

Imports torch and the port only, never JAX.  The rank joins a gloo
group over a ``FileStore`` on the CPU, reads its inputs from the task's
``.npz``, runs the task's jobs on its partition and writes its slabs to
``<out>/rank<RANK>.npz``:

- ``spmm``: ``spmm`` and ``spmm_transpose`` on the rank's share of the
  sharded operator, for each graph × exchange × format × gather dtype;
- ``forward``: the model forward (eval) on ``prepare_sharded_data``'s
  operators, from the given parameters;
- ``runner``: ``make_split_runner`` with the process group, from the
  given parameters and masks;
- ``experiment``: ``run_experiment_sharded``;
- ``resume``: ``run_experiment_sharded`` with checkpointed segments,
  uninterrupted and cut at half the last split's epochs then resumed,
  uninterrupted with a fresh split runner for every segment, and without
  checkpoints: each run's results, parameters and snapshots;
- ``retry``: ``run_experiment_sharded`` with a transient failure injected
  on some ranks after split 0's first attempt: its result, or the error
  each rank raised;
- ``batchnorm``: acmgcnpp's BatchNorm across the ranks, from the given
  parameters and statistics: the train-mode forward, the gradients of
  ``Σ logits·weights`` over every rank's rows (summed over the ranks),
  the running statistics after it, and a split runner's run;
- ``experiment_from``: ``run_experiment_sharded`` with each split's
  initial parameters read from the inputs in place of ``build_model``'s
  draw.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from acmgnn_tpu_torch.ops.graph import (  # noqa: E402
    GraphData,
    row_normalized_adjacency,
)
from acmgnn_tpu_torch.ops.spmm import spmm, spmm_transpose  # noqa: E402
from acmgnn_tpu_torch.parallel.multihost import (  # noqa: E402
    all_reduce_sum,
    init_distributed,
)
from acmgnn_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_coo_op,
    make_sharded_ell_op,
    shard_node_array,
)
from acmgnn_tpu_torch.train import trainer  # noqa: E402
from acmgnn_tpu_torch.train.config import TrainConfig  # noqa: E402
from acmgnn_tpu_torch.train.trainer import (  # noqa: E402
    build_model,
    make_split_runner,
    prepare_sharded_data,
    run_experiment_sharded,
)
from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def graph(inputs, name):
    return sp.csr_matrix((inputs[f"{name}_data"], inputs[f"{name}_indices"],
                          inputs[f"{name}_indptr"]),
                         shape=tuple(inputs[f"{name}_shape"]))


def run_spmm(job, inputs, rank, world, out):
    adj = graph(inputs, job["graph"])
    a_hat = row_normalized_adjacency(adj)
    make = make_sharded_ell_op if job["fmt"] == "ell" else make_sharded_coo_op
    kw = ({"gather_dtype": DTYPES[job["dtype"]]} if job["fmt"] == "ell"
          else {})
    op, boundaries = make(a_hat, world, rank, exchange=job["exchange"], **kw)
    x = shard_node_array(inputs[f"{job['graph']}_x"], boundaries,
                         op.rows_per_part, rank)
    g = shard_node_array(inputs[f"{job['graph']}_g"], boundaries,
                         op.rows_per_part, rank)
    key = job["key"]
    out[f"{key}/fwd"] = spmm(op, x).numpy()
    out[f"{key}/bwd"] = spmm_transpose(op, g).numpy()
    out[f"{key}/halo"] = np.asarray(op.send_idx is not None)
    out[f"{key}/rows"] = np.asarray([op.rows_sent, op.rows_received])


def _data(inputs, job):
    return GraphData("g", graph(inputs, job["graph"]),
                     inputs[f"{job['graph']}_features"],
                     inputs[f"{job['graph']}_labels"])


def _model(inputs, job, prep, cfg):
    """The model with the parameters the test saved under ``job["params"]``
    (a ``state_dict`` from ``params_from_flax``)."""
    model = build_model(cfg, prep.x.shape[1], prep.nclass, device="cpu",
                        nnodes=prep.data.num_nodes)
    prefix = job["params"]
    model.load_state_dict({key[len(prefix):]: torch.from_numpy(inputs[key])
                           for key in inputs.files if key.startswith(prefix)})
    return model


def run_forward(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    prep = prepare_sharded_data(_data(inputs, job), cfg,
                                group=dist.group.WORLD, device="cpu",
                                exchange=job["exchange"])
    model = _model(inputs, job, prep, cfg)
    with torch.no_grad():
        out[f"{job['key']}/logits"] = model(prep.x, prep.ops,
                                            training=False).numpy()


def run_runner(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    prep = prepare_sharded_data(_data(inputs, job), cfg,
                                group=dist.group.WORLD, device="cpu",
                                exchange=job["exchange"])
    model = _model(inputs, job, prep, cfg)
    masks = tuple(prep.place(m) for m in inputs[job["masks"]])
    res = make_split_runner(model, cfg, group=dist.group.WORLD)(
        prep.ops, prep.x, prep.labels, masks,
        labels_onehot=prep.labels_onehot)
    _save_result(out, job["key"], res, model)


def run_experiment(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    data = _data(inputs, job)
    # the replicas start equal: every rank builds split 0's model alike
    start = build_model(cfg, data.features.shape[1], data.num_classes,
                        device="cpu", seed=cfg.seed)
    out[f"{job['key']}/start_equal"] = np.asarray(_replicas_equal(start))
    res, model = run_experiment_sharded(
        data, cfg, device="cpu", exchange=job["exchange"], return_model=True)
    out[f"{job['key']}/test_mean"] = np.asarray(res["test_mean"])
    out[f"{job['key']}/epochs_total"] = np.asarray(res["epochs_total"])
    out[f"{job['key']}/devices"] = np.asarray(res["devices"])
    _save_params(out, job["key"], model)


class Cut(Exception):
    """The interruption of a checkpointed run."""


def cut_resumed(run, epochs, last_split, ckpt_dir):
    """``run(checkpoint_dir, resume)`` cut right after the first snapshot
    of split ``last_split`` at half the epochs or later: every rank cuts
    at the next segment's call of the runner, after rank 0 wrote the
    snapshot; then, once every rank is there, run again with ``resume``:
    the resumed run's result and model."""
    make = trainer.make_split_runner

    def cutting(model, cfg, **kwargs):
        runner = make(model, cfg, **kwargs)

        def run_segment(*args, **kw):
            st = kw.get("init_state")
            if (kw.get("seed") == cfg.seed + last_split and st is not None
                    and st.bodies >= epochs // 2):
                raise Cut(st.bodies)
            return runner(*args, **kw)
        return run_segment

    trainer.make_split_runner = cutting
    try:
        run(ckpt_dir, False)
        raise AssertionError("the run was not cut")
    except Cut:
        pass
    finally:
        trainer.make_split_runner = make
    if dist.is_initialized():
        dist.barrier()
    return run(ckpt_dir, True)


def fresh_runners(run, ckpt_dir):
    """``run(checkpoint_dir, False)`` with a new split runner made for
    every call of the run's runner (every split and segment), in place of
    the one runner a run keeps."""
    make = trainer.make_split_runner

    def per_call(model, cfg, **kwargs):
        def runner(*args, **kw):
            return make(model, cfg, **kwargs)(*args, **kw)
        return runner

    trainer.make_split_runner = per_call
    try:
        return run(ckpt_dir, False)
    finally:
        trainer.make_split_runner = make


def snapshot_arrays(ckpt_dir, rank):
    """Every tensor of this rank's last snapshots, flattened by name."""
    out = {}

    def walk(tree, name):
        if isinstance(tree, torch.Tensor):
            out[name] = tree.numpy()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{name}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{name}/{i}")
        elif tree is not None:
            out[name] = np.asarray(tree)

    for f in sorted(os.listdir(ckpt_dir)):
        if f.endswith("_state"):
            walk(restore_checkpoint(os.path.join(ckpt_dir, f)), f)
    return out


def run_resume(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    data = _data(inputs, job)
    key = job["key"]
    every = job["every"]
    # the same directory on every rank: rank 0 writes the shared state
    base = os.path.join(job["dir"], key.replace("/", "_"))

    def run(ckpt_dir, resume):
        return run_experiment_sharded(
            data, cfg, device="cpu", checkpoint_dir=ckpt_dir,
            checkpoint_every=every, resume=resume, return_model=True)

    runs = {"plain": run_experiment_sharded(data, cfg, device="cpu",
                                            return_model=True),
            "whole": run(f"{base}/whole", False),
            "resumed": cut_resumed(run, cfg.epochs, cfg.num_splits - 1,
                                   f"{base}/cut"),
            "fresh": fresh_runners(run, f"{base}/fresh")}
    if dist.is_initialized():
        dist.barrier()
    for name, (res, model) in runs.items():
        out[f"{key}/{name}/per_split"] = np.asarray(res["per_split"])
        out[f"{key}/{name}/epochs_total"] = np.asarray(res["epochs_total"])
        for pname, p in model.state_dict().items():
            out[f"{key}/{name}/param/{pname}"] = p.numpy()
    for name in ("whole", "cut", "fresh"):
        for k, v in snapshot_arrays(f"{base}/{name}", rank).items():
            out[f"{key}/{name}/snap/{k}"] = v


def run_retry(job, inputs, rank, world, out):
    import time

    cfg = TrainConfig(**job["cfg"])
    data = _data(inputs, job)
    sync, sleep = trainer._sync, time.sleep
    injected = []

    def flaky(dev):   # the end of a split's attempt
        sync(dev)
        if not injected and rank in job["fail"]:
            injected.append(True)
            raise RuntimeError("UNAVAILABLE: an injected failure")

    trainer._sync, time.sleep = flaky, (lambda s: None)   # and no backoff
    try:
        res, model = run_experiment_sharded(
            data, cfg, device="cpu", exchange=job["exchange"],
            return_model=True)
    except RuntimeError as exc:
        out[f"{job['key']}/raised"] = np.asarray(str(exc))
    else:
        out[f"{job['key']}/test_mean"] = np.asarray(res["test_mean"])
        _save_params(out, job["key"], model)
    finally:
        trainer._sync, time.sleep = sync, sleep


def run_batchnorm(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    prep = prepare_sharded_data(_data(inputs, job), cfg,
                                group=dist.group.WORLD, device="cpu",
                                exchange=job["exchange"])
    key = job["key"]
    model = _model(inputs, job, prep, cfg)
    logits = model(prep.x, prep.ops, training=True)
    (logits * prep.place(inputs[job["weights"]])).sum().backward()
    params = list(model.named_parameters())
    grads = all_reduce_sum(torch.cat([p.grad.reshape(-1) for _, p in params]))
    for (name, p), g in zip(params, grads.split([p.numel()
                                                 for _, p in params])):
        out[f"{key}/grad/{name}"] = g.view_as(p).numpy()
    out[f"{key}/logits"] = logits.detach().numpy()
    for name, b in model.named_buffers():
        out[f"{key}/buffer/{name}"] = b.numpy()
    model = _model(inputs, job, prep, cfg)
    res = make_split_runner(model, cfg, group=dist.group.WORLD)(
        prep.ops, prep.x, prep.labels,
        tuple(prep.place(m) for m in inputs[job["masks"]]),
        labels_onehot=prep.labels_onehot)
    _save_result(out, f"{key}/runner", res, model)


def run_experiment_from(job, inputs, rank, world, out):
    cfg = TrainConfig(**job["cfg"])
    build = trainer.build_model

    def from_inputs(c, nfeat, nclass, *, device=None, seed=0, nnodes=None):
        model = build(c, nfeat, nclass, device=device, seed=seed,
                      nnodes=nnodes)
        prefix = f"{job['params']}{seed - c.seed}/"
        model.load_state_dict({k[len(prefix):]: torch.from_numpy(inputs[k])
                               for k in inputs.files if k.startswith(prefix)})
        return model

    trainer.build_model = from_inputs
    try:
        res, model = run_experiment_sharded(
            _data(inputs, job), cfg, device="cpu", exchange=job["exchange"],
            return_model=True)
    finally:
        trainer.build_model = build
    out[f"{job['key']}/per_split"] = np.asarray(res["per_split"])
    out[f"{job['key']}/epochs_total"] = np.asarray(res["epochs_total"])
    _save_params(out, job["key"], model)


def _save_result(out, key, res, model):
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        out[f"{key}/{field}"] = np.asarray(float(getattr(res, field)))
    out[f"{key}/epochs_run"] = np.asarray(res.epochs_run)
    _save_params(out, key, model)


def _replicas_equal(model) -> bool:
    """Whether this rank's parameters equal rank 0's (a broadcast)."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(flat, ref))


def _save_params(out, key, model):
    """Parameters, and whether every rank holds rank 0's."""
    out[f"{key}/replicas_equal"] = np.asarray(_replicas_equal(model))
    for name, p in model.named_parameters():
        out[f"{key}/param/{name}"] = p.detach().numpy()


JOBS = {"spmm": run_spmm, "forward": run_forward, "runner": run_runner,
        "experiment": run_experiment, "resume": run_resume,
        "retry": run_retry, "batchnorm": run_batchnorm,
        "experiment_from": run_experiment_from}


def main():
    task = json.loads(open(sys.argv[1]).read())
    rank, world = int(sys.argv[2]), int(task["world"])
    torch.set_num_threads(1)
    init_distributed(backend="gloo", device="cpu", rank=rank,
                     world_size=world,
                     store=dist.FileStore(task["store"], world))
    inputs = np.load(task["inputs"])
    out: dict = {}
    for job in task["jobs"]:
        JOBS[job["kind"]](job, inputs, rank, world, out)
    np.savez(os.path.join(task["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
