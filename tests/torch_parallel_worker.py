"""One rank of the two-process gloo run of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK PORT DIR

``DIR`` holds the inputs the test wrote (``inputs.pt``) and receives this
rank's results (``rank<RANK>.pt``).  Both meshes of two processes, (2, 1)
and (1, 2), are built over the one process group, and each runs the
``mesh`` job: three PMR train steps on the inputs' global batches (each
rank its rows), then the full state dict; at (1, 2) a checkpoint of the
state; the mesh scorer (with the device table, then int8) and the mesh
generator on the inputs' requests; divergent device tables; a step with dropout on and
the digests of the replicated parameters after it; a mesh larger than the
world.  Then the ``resume`` job at (2, 1) restores the (1, 2) checkpoint,
takes two more steps and returns the full state dict, and the ``cli`` job
runs ``run_pmr --multihost`` in the same process group: ``--do_train`` at
``--mesh_model 2``, then ``--do_test`` from its checkpoint at
``--mesh_data 2`` (the tiny config without mapping dropout, as the test's
one-process run).

Imports the port only (torch, numpy): no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from multimodal_context_reasoning_torch.core.config import TrainConfig  # noqa: E402
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable  # noqa: E402
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures  # noqa: E402
from multimodal_context_reasoning_torch.models.modcr import ModCRModel  # noqa: E402
from multimodal_context_reasoning_torch.models.rationale import RationaleModel  # noqa: E402
from multimodal_context_reasoning_torch.parallel import (  # noqa: E402
    gather_state_dict,
    local_rows,
    make_mesh,
    shard_module_,
)
from multimodal_context_reasoning_torch.parallel.mesh import axis_index  # noqa: E402
from multimodal_context_reasoning_torch.parallel.multihost import digest  # noqa: E402
from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator  # noqa: E402
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer  # noqa: E402
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager  # noqa: E402
from multimodal_context_reasoning_torch.train.state import TrainState  # noqa: E402
from multimodal_context_reasoning_torch.train.step import train_step  # noqa: E402


def sharded_state(inp, mesh, cfg=None):
    model = ModCRModel(cfg or inp["cfg"], device="cpu")
    model.load_state_dict(inp["init"], strict=True)
    shard_module_(model, mesh)
    return TrainState.create(model, TrainConfig(**inp["tcfg"]), inp["total_steps"])


def steps(state, batches, mesh):
    return [{k: float(v) for k, v in train_step(state, local_rows(b, mesh)).items()}
            for b in batches]


def raised(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def mesh_job(inp, mesh, shape, directory):
    out = {}
    state = sharded_state(inp, mesh)
    out["metrics"] = steps(state, inp["batches"][:3], mesh)
    out["params"] = gather_state_dict(state.model)
    if shape == (1, 2):
        CheckpointManager(os.path.join(directory, "ckpt")).save(state, {"accuracy": 0.5})

    scorer = ModCRScorer(inp["score_cfg"], inp["init"], inp["bert"], inp["rob"], inp["feats"],
                         micro_batch=2, device="cpu", use_device_table=True, mesh=mesh)
    out["scores"] = scorer.score(inp["requests"])
    out["int8_scores"] = ModCRScorer(
        inp["score_cfg"].with_quantize("int8"), inp["init"], inp["bert"], inp["rob"],
        inp["feats"], micro_batch=2, device="cpu", mesh=mesh).score(inp["requests"])
    out["score_micro_batch_error"] = raised(lambda: ModCRScorer(
        inp["score_cfg"], inp["init"], inp["bert"], inp["rob"], inp["feats"],
        micro_batch=1, device="cpu", mesh=mesh))

    g = inp["gen"]
    model = RationaleModel(*g["cfgs"], max_chunks=8, device="cpu")
    model.load_state_dict(g["weights"], strict=True)
    gen = RationaleGenerator(*g["cfgs"], model, inp["bert"], g["gpt_tok"], inp["feats"],
                             spec=g["spec"], max_chunks=8, micro_batch=2,
                             max_rationale_len=6, device="cpu", mesh=mesh)
    out["generated"] = gen.generate(inp["requests"])

    feats = dict(inp["feats"])
    if dist.get_rank() == 1:
        key = sorted(feats)[0]
        f = feats[key].features.copy()
        f[0, 0] += 1.0
        feats[key] = ImageFeatures(features=f, num_regions=feats[key].num_regions)
    table = DeviceFeatureTable(feats, img_len=inp["cfg"].img_len, dtype="float32", device="cpu")
    out["divergent_table_error"] = raised(lambda: table.place(mesh))

    # dropout on: the global RNG seeded per data index, as Trainer seeds it
    torch.manual_seed(88 + axis_index(mesh, "data"))
    c = inp["cfg"]
    drop = dataclasses.replace(
        c, mapping_dropout=0.1,
        roberta=dataclasses.replace(c.roberta, hidden_dropout_prob=0.1,
                                    attention_probs_dropout_prob=0.1))
    dstate = sharded_state(inp, mesh, drop)
    out["dropout_metrics"] = steps(dstate, inp["batches"][:1], mesh)
    plan = dstate.model.tp_plan
    out["replicated_digests"] = {n: digest(p).tolist()
                                 for n, p in dstate.model.named_parameters() if n not in plan}
    out["too_large_error"] = raised(lambda: make_mesh((shape[0], 2 * shape[1])))
    return out


def resume_job(inp, mesh, directory):
    state = sharded_state(inp, mesh)
    CheckpointManager(os.path.join(directory, "ckpt")).restore(state)
    out = {"restored_step": state.step, "restored_count": state.optimizer.count}
    out["metrics"] = steps(state, inp["batches"][3:5], mesh)
    out["params"] = gather_state_dict(state.model)
    return out


def cli_job(inp, directory):
    from multimodal_context_reasoning_torch.cli import run_pmr
    from multimodal_context_reasoning_torch.core.config import ModCRConfig

    tiny = ModCRConfig.tiny
    ModCRConfig.tiny = classmethod(
        lambda cls: dataclasses.replace(tiny(), mapping_dropout=0.0))
    train, test = (os.path.join(directory, f"mesh_{n}") for n in ("train", "test"))
    run_pmr.main(inp["cli_argv"] + ["--multihost", "--mesh_model", "2", "--do_train",
                                    "--output_dir", train])
    run_pmr.main(inp["cli_argv"] + ["--multihost", "--mesh_data", "2", "--do_test",
                                    "--eval_model_dir", train, "--output_dir", test])
    return {"done": True}


def main(argv):
    rank, port, directory = int(argv[0]), argv[1], argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    out = {}
    try:
        inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        meshes = {shape: make_mesh(shape) for shape in ((2, 1), (1, 2))}
        for shape, mesh in meshes.items():
            out[shape] = mesh_job(inp, mesh, shape, directory)
        out["resume"] = resume_job(inp, meshes[(2, 1)], directory)
        out["cli"] = cli_job(inp, directory)
    except Exception:  # reported to the test, which fails with it
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
