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
- ``experiment``: ``run_experiment_sharded``.
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
from acmgnn_tpu_torch.parallel.multihost import init_distributed  # noqa: E402
from acmgnn_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_coo_op,
    make_sharded_ell_op,
    shard_node_array,
)
from acmgnn_tpu_torch.train.config import TrainConfig  # noqa: E402
from acmgnn_tpu_torch.train.trainer import (  # noqa: E402
    build_model,
    make_split_runner,
    prepare_sharded_data,
    run_experiment_sharded,
)

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
    model = build_model(cfg, prep.x.shape[1], prep.nclass, device="cpu")
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
        data, cfg, device="cpu", exchange=job["exchange"],
        return_model=True)
    out[f"{job['key']}/test_mean"] = np.asarray(res["test_mean"])
    out[f"{job['key']}/epochs_total"] = np.asarray(res["epochs_total"])
    out[f"{job['key']}/devices"] = np.asarray(res["devices"])
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
        "experiment": run_experiment}


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
