"""The port's logger (``finmlkit_tpu_torch/utils/log.py``), as
``tests/utils/test_logger.py`` holds the JAX package's: the console handler and
its level from the environment, the rotating file handler with its
directories, one set of handlers however often it is asked for, the noisy
libraries at WARNING and no propagation, all under the root
``finmlkit_tpu_torch``. The JAX module keeps a name that starts with
``finmlkit_tpu``, so ``finmlkit_tpu_torch.x`` passes its test too; the port's
root is its own, and leaves the JAX root's handlers alone."""
import importlib
import logging
import logging.handlers

import pytest

import finmlkit_tpu_torch.utils.log as logmod

ROOT = "finmlkit_tpu_torch"


@pytest.fixture
def fresh_logmod(monkeypatch):
    """The log module reloaded with no handlers on its root and no FMKT_*
    variables; the handlers are put back after the test."""
    for var in ("FMKT_LOG_FILE_PATH", "FMKT_FILE_LOGGER_LEVEL",
                "FMKT_CONSOLE_LOGGER_LEVEL"):
        monkeypatch.delenv(var, raising=False)
    root = logging.getLogger(ROOT)
    old_handlers = root.handlers[:]
    root.handlers.clear()
    mod = importlib.reload(logmod)
    yield mod
    for h in root.handlers:
        if h not in old_handlers:
            h.close()
    root.handlers[:] = old_handlers
    importlib.reload(logmod)


def _handlers():
    return logging.getLogger(ROOT).handlers


def _consoles():
    return [h for h in _handlers() if isinstance(h, logging.StreamHandler)
            and not isinstance(h, logging.FileHandler)]


def _flush():
    for h in _handlers():
        h.flush()


def test_console_handler_created_at_warning(fresh_logmod):
    lg = fresh_logmod.get_logger("unit_test")
    assert len(_consoles()) == 1
    assert _consoles()[0].level == logging.WARNING
    assert lg.name == "finmlkit_tpu_torch.unit_test"


def test_console_level_env_override(fresh_logmod, monkeypatch):
    monkeypatch.setenv("FMKT_CONSOLE_LOGGER_LEVEL", "DEBUG")
    importlib.reload(logmod).get_logger("x")
    assert _consoles()[0].level == logging.DEBUG


def test_no_file_handler_without_env(fresh_logmod):
    fresh_logmod.get_logger("y")
    assert not [h for h in _handlers() if isinstance(h, logging.FileHandler)]


@pytest.mark.parametrize("name, want", [
    ("sub.module", "finmlkit_tpu_torch.sub.module"),
    ("finmlkit_tpu_torch", "finmlkit_tpu_torch"),
    ("finmlkit_tpu_torch.bar", "finmlkit_tpu_torch.bar"),
    # the JAX package's names and a name that only starts like the root
    ("finmlkit_tpu.bar", "finmlkit_tpu_torch.finmlkit_tpu.bar"),
    ("finmlkit_tpu", "finmlkit_tpu_torch.finmlkit_tpu"),
    ("finmlkit_tpu_torchx", "finmlkit_tpu_torch.finmlkit_tpu_torchx"),
])
def test_package_prefix_applied(fresh_logmod, name, want):
    assert fresh_logmod.get_logger(name).name == want


def test_port_modules_log_under_the_port_root():
    from finmlkit_tpu_torch.bar import data_model
    from finmlkit_tpu_torch.data import store
    from finmlkit_tpu_torch.feature import utils
    for mod in (data_model, store, utils):
        assert mod.logger.name == mod.__name__
        assert mod.logger.name.startswith(ROOT + ".")


def test_jax_root_left_alone(fresh_logmod):
    jroot = logging.getLogger("finmlkit_tpu")
    before = jroot.handlers[:]
    fresh_logmod.get_logger("finmlkit_tpu.bar")
    assert jroot.handlers == before
    assert logging.getLogger(ROOT).handlers


def test_file_created_with_parent_dirs(fresh_logmod, monkeypatch, tmp_path):
    log_file = tmp_path / "nested" / "dir" / "fmkt.log"
    monkeypatch.setenv("FMKT_LOG_FILE_PATH", str(log_file))
    monkeypatch.setenv("FMKT_FILE_LOGGER_LEVEL", "INFO")
    lg = importlib.reload(logmod).get_logger("filetest")
    lg.info("hello file")
    _flush()
    assert log_file.exists()
    assert "hello file" in log_file.read_text()
    assert "finmlkit_tpu_torch.filetest" in log_file.read_text()


def test_file_level_respected(fresh_logmod, monkeypatch, tmp_path):
    log_file = tmp_path / "warn.log"
    monkeypatch.setenv("FMKT_LOG_FILE_PATH", str(log_file))
    monkeypatch.setenv("FMKT_FILE_LOGGER_LEVEL", "WARNING")
    lg = importlib.reload(logmod).get_logger("leveltest")
    lg.info("too quiet")
    lg.warning("loud enough")
    _flush()
    text = log_file.read_text()
    assert "loud enough" in text
    assert "too quiet" not in text


def test_rotating_handler_configured(fresh_logmod, monkeypatch, tmp_path):
    monkeypatch.setenv("FMKT_LOG_FILE_PATH", str(tmp_path / "r.log"))
    importlib.reload(logmod).get_logger("rot")
    fhs = [h for h in _handlers()
           if isinstance(h, logging.handlers.TimedRotatingFileHandler)]
    assert len(fhs) == 1
    assert fhs[0].backupCount == 7
    assert fhs[0].when.upper() == "MIDNIGHT"


def test_no_duplicate_handlers(fresh_logmod):
    fresh_logmod.get_logger("a")
    n1 = len(_handlers())
    fresh_logmod.get_logger("b")
    fresh_logmod.get_logger("a")
    assert len(_handlers()) == n1 == 1


def test_same_name_same_instance(fresh_logmod):
    assert fresh_logmod.get_logger("z") is fresh_logmod.get_logger("z")


@pytest.mark.parametrize("name", ["torch", "urllib3", "matplotlib", "h5py"])
def test_noisy_loggers_warning_or_higher(fresh_logmod, name):
    fresh_logmod.get_logger("trigger_config")
    assert logging.getLogger(name).level >= logging.WARNING


def test_root_does_not_propagate(fresh_logmod):
    fresh_logmod.get_logger("p")
    assert logging.getLogger(ROOT).propagate is False
