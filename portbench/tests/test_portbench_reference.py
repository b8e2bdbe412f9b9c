"""The plain reference against the port's plain path on the CPU, from the
same weights and inputs, which ``inputs.py`` makes from a seed."""

import pytest
import torch

from portbench import inputs
from portbench.reference.diffusion import Schedule
from portbench.reference.head import PixelClassifier, probabilities
from portbench.reference.unet import Unet

DIM, MULTS, SIZE = 16, (1, 2, 4), 32


def both(seed):
    from tedm_tpu_torch.models.unet import Unet as PortUnet

    ref = Unet(DIM, MULTS)
    port = PortUnet(dim=DIM, dim_mults=MULTS, use_pallas=False)
    weights = inputs.weights(ref.state_dict(), seed, "unet", "cpu")
    ref.load_state_dict(weights)
    port.load_state_dict(weights)
    return ref, port


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_unet_and_features_match_the_ports_plain_path(seed):
    ref, port = both(seed)
    x = inputs.images(seed, 3, SIZE, "cpu") * 2 - 1
    t = torch.tensor([1, 400, 999])
    with torch.no_grad():
        out_r, feats_r = ref(x, t, features=True)
        out_p, feats_p = port(x, t, extract_features=True)
    for a, b in zip([out_r] + feats_r, [out_p] + feats_p):
        assert (a - b).abs().max().item() <= 2e-5 * max(1.0, b.abs().max().item())


def test_weights_follow_torchs_default_rules():
    ref = Unet(DIM, MULTS)
    w = inputs.weights(ref.state_dict(), 5, "unet", "cpu")
    assert torch.equal(w["downs.0.0.block1.norm.weight"], torch.ones(DIM))
    assert torch.equal(w["downs.0.2.fn.norm.g"], torch.ones(1, DIM, 1, 1))
    bound = (DIM * 9) ** -0.5
    assert w["downs.0.0.block1.proj.weight"].abs().max() <= bound
    assert w["downs.0.0.block1.proj.bias"].abs().max() <= bound
    assert w["downs.0.0.block1.proj.weight"].std().item() == pytest.approx(bound / 3 ** 0.5, rel=0.05)
    assert torch.equal(w["downs.0.0.block1.proj.weight"], inputs.weights(ref.state_dict(), 5, "unet", "cpu")[
        "downs.0.0.block1.proj.weight"])


def test_serving_probabilities_match_the_ports_task():
    from tedm_tpu_torch.models.segmentation import PixelClassifier as PortHead
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers.datasetdm import SegTask

    ref, port = both(7)
    stages = [DIM * m for m in reversed(MULTS)]
    head = PixelClassifier(sum(stages)).eval()
    port_head = PortHead(stage_channels=stages, img_size=SIZE, shared=True).eval()
    w = inputs.weights(head.state_dict(), 7, "head", "cpu")
    head.load_state_dict(w)
    port_head.load_state_dict(w)
    t_steps = (1, 10, 25, 50, 200, 400, 600, 800)
    task = SegTask(unet=port.eval(), classifier=port_head, sched=make_schedule(1000, "cosine"), t_steps=t_steps,
                   normalize=True, fold=len(t_steps))
    images = inputs.images(7, 2, SIZE, "cpu")
    noise = torch.randn((len(t_steps) * 2, 1, SIZE, SIZE), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = torch.sigmoid(task.apply(images, noise=noise)).reshape(len(t_steps), 2, 1, SIZE, SIZE).mean(0)
        got = probabilities(ref.eval(), head, Schedule(1000, "cosine"), images, t_steps, noise)
    assert (got - want).abs().max().item() <= 1e-6


def test_the_training_references_precision_follows_the_configuration():
    """fp32 leaves the reference as it is; bf16 rounds the UNet's output (and
    its gradient) to bf16, the fp8 control to fp8 with a scale a tensor."""
    from portbench.reference import precision, train as ref_train

    assert precision.stored("fp32") is None and precision.control_stored("fp32") is None
    x = torch.tensor([1.0 + 2 ** -10, 3.0, -0.1], requires_grad=True)
    y = precision.apply(precision.stored("bf16"), x)
    assert torch.equal(y, x.detach().to(torch.bfloat16).float())
    y.backward(torch.tensor([1.0 + 2 ** -10, 1.0, 1.0]))
    assert x.grad[0].item() == 1.0  # the gradient is rounded on its way back
    z = precision.control_stored("bf16")(torch.tensor([448.0, 1.0, 0.3]))
    assert z[0].item() == 448.0 and z[2].item() != 0.3

    torch.manual_seed(0)
    model = Unet(8, (1, 2))
    batches = [(torch.rand(2, 1, 16, 16), torch.tensor([3, 700]), torch.randn(2, 1, 16, 16))] * 3
    losses = []
    for out in (None, precision.bf16):
        m = Unet(8, (1, 2))
        m.load_state_dict(model.state_dict())
        losses.append(ref_train.run(m, Schedule(1000, "cosine"), batches, 1e-4, 0.9999, 2, out_rounding=out).losses)
    assert losses[0] != losses[1]
    assert max(abs(a - b) / a for a, b in zip(*losses)) < 1e-2
