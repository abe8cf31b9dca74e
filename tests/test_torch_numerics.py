"""The port's CUDA numerics (utils/device.py): every entry point that
resolves a CUDA device sets full float32 (no TF32 in cuDNN or cuBLAS) and
cuDNN's deterministic algorithms; a CPU device leaves the process's
settings alone. Building a torch.device needs no card, so those tests run
here. On the card (marked ``cuda``; this file imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_numerics.py -q

two runs of a small joint train step from one seed give the same params
and optimizer state to the bit."""
import pytest
import torch

from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.parallel import mesh
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_joint_train_step)
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

FLAGS = (("cudnn", torch.backends.cudnn, "allow_tf32", False),
         ("cuda.matmul", torch.backends.cuda.matmul, "allow_tf32", False),
         ("cudnn", torch.backends.cudnn, "deterministic", True),
         ("cudnn", torch.backends.cudnn, "benchmark", False))
TORCH_DEFAULTS = dict(allow_tf32=True, deterministic=False, benchmark=True)


@pytest.fixture
def torch_defaults():
    """The flags at the opposite of the port's setting for the test (cuDNN
    TF32 on, as torch ships it), restored afterwards."""
    saved = [getattr(obj, name) for _, obj, name, _ in FLAGS]
    for _, obj, name, _ in FLAGS:
        setattr(obj, name, TORCH_DEFAULTS[name])
    yield
    for (_, obj, name, _), v in zip(FLAGS, saved):
        setattr(obj, name, v)


def _flags():
    return {f"{where}.{name}": getattr(obj, name) for where, obj, name, _ in FLAGS}


@pytest.mark.parametrize("entry", ["resolve_device", "resolve_device(torch.device)",
                                   "make_mesh's device"])
def test_a_cuda_device_gets_the_port_numerics(torch_defaults, entry):
    call = {"resolve_device": lambda: resolve_device("cuda"),
            "resolve_device(torch.device)": lambda: resolve_device(torch.device("cuda", 0)),
            "make_mesh's device": lambda: mesh._device_for(0, "cuda")}[entry]
    assert call().type == "cuda"
    assert _flags() == {f"{where}.{name}": want for where, _, name, want in FLAGS}


def test_a_cpu_device_leaves_the_numerics_alone(torch_defaults):
    before = _flags()
    assert resolve_device("cpu") == torch.device("cpu")
    Model("wavenet-ctc", {"model": {"base": {"signal_dim": 8, "dilations": [1]},
                                    "classifier": {"dilations": [1]}}}, device="cpu")
    assert _flags() == before


@pytest.mark.cuda
def test_two_train_runs_from_one_seed_are_bit_equal():
    """3 joint steps (bf16 off; causal blocks on B4/B5, the classifier's
    non-causal blocks on cuDNN, B1/B2) twice from the same init and
    batches: the same bits, with cuDNN TF32 and autotuning switched back
    on before the model is built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's numerics apply only on the card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.benchmark = True
    cfg = {"model": {"base": {"signal_dim": 32, "dilations": [1, 2, 4]},
                     "classifier": {"dilations": [1, 2, 4], "downsample": 2}}}
    g = torch.Generator().manual_seed(0)
    batches = [{"signal": torch.randint(0, 32, (4, 400), generator=g, dtype=torch.int32),
                "labels": torch.randint(1, 5, (4, 30), generator=g, dtype=torch.int32),
                "label_lengths": torch.full((4,), 30, dtype=torch.int32)} for _ in range(3)]
    runs = []
    for _ in range(2):
        model = Model("wavenet-ctc", cfg).init(0)
        tx = build_optimizer("adam", 1e-3)
        step = make_joint_train_step(model.model_base, model.model_ctc, tx, JointLoss("joint"))
        state = TrainState.create(model.params(), tx)
        for b in batches:
            state, _ = step(state, b)
        runs.append([t.cpu() for t in tree_leaves((state.params, state.opt_state))])
    assert not torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.deterministic
    assert all(torch.equal(a, b) for a, b in zip(*runs))
