"""Carry a JAX package backbone checkpoint (``tedm_tpu``'s Orbax directory)
into a checkpoint of the PyTorch port (``state.pt`` + ``config.json``), so
that the port's heads train on the very weights the JAX package's heads
trained on: the same restore as ``tedm_tpu.trainers.datasetdm.load_backbone``
(the EMA weights when the checkpoint has them), mapped by
``tedm_tpu_torch.utils.convert.unet_state_dict``; then one forward of two
random images (t = 1 and 500) through both packages, and the largest
difference of the outputs. Runs on the CPU; it imports both packages, as
the port's tests do.

    python scripts/jax_backbone_to_port.py --jax_dir RUNS/CXR14/run/best --out PORT/CXR14/run/best
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax_dir", required=True, help="a tedm_tpu backbone checkpoint directory")
    ap.add_argument("--out", required=True, help="the port checkpoint directory to write")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from tedm_tpu.trainers.datasetdm import load_backbone
    from tedm_tpu.utils.checkpoint import load_config
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint
    from tedm_tpu_torch.utils.convert import unet_state_dict

    old = load_config(args.jax_dir)
    head = old.replace(experiment="PDDM", saved_diffusion_model=os.path.abspath(args.jax_dir))
    unet, params, _ = load_backbone(head, jax.random.PRNGKey(0))
    state = {k: torch.from_numpy(np.array(v)) for k, v in unet_state_dict(jax.tree_util.tree_map(np.asarray, params)).items()}
    config = Config.load(os.path.join(os.path.abspath(args.jax_dir), "config.json"))
    save_checkpoint(args.out, {"params": state, "step": 0}, config)
    print(f"wrote {args.out}: {len(state)} tensors, {sum(v.numel() for v in state.values())} parameters")

    from tedm_tpu_torch.trainers.datasetdm import load_backbone as port_backbone
    from tedm_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    port, _ = port_backbone(config.replace(experiment="PDDM", saved_diffusion_model=os.path.abspath(args.out)), "cpu")
    x = np.random.RandomState(0).randn(2, old.img_size, old.img_size, old.channels).astype(np.float32)
    t = np.array([1, 500], np.int32)
    want = np.asarray(unet.apply({"params": params}, x, t))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(t).long())
    got = got.numpy().transpose(0, 2, 3, 1)
    print(f"one forward, port against JAX: largest difference {np.abs(got - want).max():.3e} "
          f"(largest output {np.abs(want).max():.3f})")


if __name__ == "__main__":
    main()
