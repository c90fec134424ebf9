"""The port's launch modes (food101_sr_tpu_torch/parallel/distributed.py),
mirroring tests/test_distributed_config.py: the flag and environment
plumbing and the backend choice, with ``init_process_group`` replaced by a
recorder (the real two-process bring-up runs in test_torch_multihost.py
and test_torch_parallel.py)."""
import pytest
from torch_threads import one_thread  # noqa: F401

import food101_sr_tpu_torch.parallel.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE")


class _Recorder(list):
    """``init_process_group``'s calls; ``live`` is what
    ``dist.is_initialized()`` answers (the recorded call sets it)."""
    live = False

    def __call__(self, **kw):
        self.append(kw)
        self.live = True


@pytest.fixture
def calls(monkeypatch):
    seen = _Recorder()
    monkeypatch.setattr(dist.dist, "init_process_group", seen)
    monkeypatch.setattr(dist.dist, "is_initialized", lambda: seen.live)
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    return seen


def test_noop_without_request(calls):
    assert dist.maybe_initialize(device="cpu") is False
    assert calls == [] and not calls.live
    assert (dist.rank(), dist.world_size()) == (0, 1)


def test_explicit_flags_reach_init_process_group(calls):
    assert dist.maybe_initialize("h0:1234", 2, 1, device="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://h0:1234",
                      "world_size": 2, "rank": 1}]
    # idempotent: a second call does not initialize again
    assert dist.maybe_initialize("other:1", 4, 0, device="cpu") is True
    assert len(calls) == 1


def test_env_fallback(calls, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "env-host")
    monkeypatch.setenv("MASTER_PORT", "99")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert dist.maybe_initialize(device="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://env-host:99",
                      "world_size": 4, "rank": 3}]


def test_env_fallback_names_a_missing_port(calls, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "env-host")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        dist.maybe_initialize(device="cpu")
    assert calls == []


def test_auto_mode_is_env_init(calls, monkeypatch):
    for var, v in zip(dist._ENV_VARS, ("h", "7", "2", "0")):
        monkeypatch.setenv(var, v)
    assert dist.maybe_initialize(mode="auto", device="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]


@pytest.mark.parametrize("missing", ["MASTER_ADDR", "WORLD_SIZE", "RANK"])
def test_auto_mode_names_the_missing_variable(calls, monkeypatch, missing):
    for var, v in zip(dist._ENV_VARS, ("h", "7", "2", "0")):
        if var != missing:
            monkeypatch.setenv(var, v)
    with pytest.raises(ValueError, match=missing):
        dist.maybe_initialize(mode="auto", device="cpu")
    assert calls == []


def test_coordinator_requires_count_and_id(calls):
    with pytest.raises(ValueError, match="num_processes"):
        dist.maybe_initialize("h0:1", 0, -1, device="cpu")
    assert calls == []


def test_config_mapping(calls):
    cfg = {"coordinator": "c:7", "num_processes": 2, "process_id": 0,
           "distributed": ""}
    assert dist.maybe_initialize_from_config(cfg, device="cpu") is True
    assert calls[0]["world_size"] == 2 and calls[0]["rank"] == 0
    assert calls[0]["init_method"] == "tcp://c:7"


def test_config_defaults_are_a_single_process_run(calls):
    from food101_sr_tpu_torch.training import DEFAULTS

    assert dist.maybe_initialize_from_config(DEFAULTS, device="cpu") is False
    assert calls == []


@pytest.mark.parametrize("device,local,cards,backend", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 1, 1, "nccl"),     # a world of 1 on the card
    ("cuda", 2, 1, "gloo"),     # two ranks share one card: NCCL refuses
    ("cuda", 4, 4, "nccl"),
    ("cuda", 8, 4, "gloo"),
])
def test_backend_choice(device, local, cards, backend):
    assert dist.choose_backend(device, local, cards) == backend


def test_backend_on_the_card_follows_the_local_process_count(calls,
                                                             monkeypatch):
    """A loopback coordinator launches one host, so its process count is
    the world size, unless LOCAL_WORLD_SIZE says otherwise; without a card
    a CUDA launch raises before any group exists."""
    monkeypatch.setattr(dist.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist.torch.cuda, "device_count", lambda: 1)
    dist.maybe_initialize("localhost:1", 2, 0, device="cuda")
    calls.live = False
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    dist.maybe_initialize("localhost:1", 2, 1, device="cuda")
    assert [c["backend"] for c in calls] == ["gloo", "nccl"]
    calls.live = False
    monkeypatch.setattr(dist.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.maybe_initialize("localhost:1", 2, 0, device="cuda")
    assert len(calls) == 2


@pytest.mark.parametrize("how", ["flags", "env", "auto"])
@pytest.mark.parametrize("host,local,backend", [
    ("h0", "4", "nccl"),        # 2 hosts x 4 cards, LOCAL_WORLD_SIZE set
    ("h0", "8", "gloo"),        # 8 processes share a host's 4 cards
    ("h0", None, ValueError),   # may span hosts: the host's count unknown
    ("127.0.0.1", None, "gloo"),  # one host: 8 processes on 4 cards
])
def test_backend_for_a_launch_over_hosts(calls, monkeypatch, how, host,
                                         local, backend):
    """A world of 8 on hosts of 4 cards: the backend follows the host's
    own process count, which only LOCAL_WORLD_SIZE or a loopback
    coordinator tells; otherwise the launch is refused before any group
    exists, never run on gloo unannounced."""
    monkeypatch.setattr(dist.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist.torch.cuda, "device_count", lambda: 4)
    if local is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    args = {"device": "cuda"}
    if how == "flags":
        args.update(coordinator=f"{host}:5", num_processes=8, process_id=5)
    else:
        for var, v in zip(dist._ENV_VARS, (host, "5", "8", "5")):
            monkeypatch.setenv(var, v)
        args["mode"] = "auto" if how == "auto" else ""
    if backend is ValueError:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            dist.maybe_initialize(**args)
        assert calls == []
    else:
        assert dist.maybe_initialize(**args) is True
        assert [c["backend"] for c in calls] == [backend]


def test_collectives_are_no_ops_in_a_world_of_one():
    import torch

    xs = [torch.arange(4.0), torch.ones(2, 3)]
    before = [x.clone() for x in xs]
    dist.all_reduce_mean_(xs)
    dist.broadcast_(xs)
    dist.barrier()
    assert all(torch.equal(a, b) for a, b in zip(xs, before))
    assert dist.agree(True) and not dist.agree(False)
    assert dist.global_mean(xs[1]).item() == 1.0
    assert dist.global_sum(xs[0]) is xs[0]
    assert dist.rank_device("cpu").type == "cpu"
