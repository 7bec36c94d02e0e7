"""The JAX package's side of the port's multi-rank CPU tests: its Trainer
on a mesh of ``conftest``'s virtual CPU devices, on the data of
``torch_dist_worker.py``."""

import os

import numpy as np

import jax

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.parallel import DistStrategy as JStrategy
from paddle_tpu.parallel import fsdp as jfsdp
from paddle_tpu.parallel import transformer_tp_rules as jtp

import torch_dist_worker as W


def _jprogram(model):
    return pt.build(jmnist.mlp if model == "mnist" else
                    jgpt.make_model(jgpt.base_config(**W.GPT)))


def _jfeeds(model):
    return W.mnist_feeds() if model == "mnist" else W.gpt_feeds()


def jax_trainer(model, axes, rules, skw):
    mesh = pt.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    rules = {None: None, "fsdp": jfsdp(W.FSDP_MIN), "tp": jtp()}[rules]
    tr = pt.Trainer(_jprogram(model), jopt.Momentum(W.LR, W.MOMENTUM), loss_name="loss",
                    mesh=mesh, sharding_rules=rules,
                    strategy=JStrategy(**skw) if skw else None, fetch_list=["loss"])
    tr.startup(sample_feed=_jfeeds(model)[0])
    return tr


def write_initial_params(d):
    """The JAX package's initial params of both models (its startup at the
    default seed, the same on every mesh), for the ranks to start from."""
    for model in ("mnist", "gpt"):
        tr = jax_trainer(model, {"dp": 4}, None, {})
        np.savez(os.path.join(d, f"params_{model}.npz"),
                 **{k: np.asarray(v) for k, v in tr.scope.params.items()})


def jax_run(model, axes, rules, skw, steps=None):
    tr = jax_trainer(model, axes, rules, skw)
    feeds = _jfeeds(model)[:steps]
    losses = np.array([float(tr.step(f)["loss"]) for f in feeds])
    return losses, {k: np.asarray(v) for k, v in tr._logical_params().items()}
