"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``.  The port mirrors the JAX
package's module paths (``models/gpt2.py``, ``runtime/engine.py``,
``inference/serving.py``, ``ops/transformer/flash_attention.py`` ...) so
each file names its reference, and it imports neither ``jax`` nor
anything of ``deepspeed_tpu``.

Deliberate difference: importing the package is light.  The JAX facade
imports the training engine eagerly; here nothing below the package is
imported until a caller asks for it (:func:`initialize`,
:func:`init_inference`, ``deepspeed_tpu_torch.inference``,
``deepspeed_tpu_torch.models``), and no kernel is built at import time —
CUDA sources compile at the first launch (``ops/op_builder/cuda.py``).
"""

from .version import __version__


def initialize(model=None, training_data=None, config=None, loss_fn=None, params=None,
               rng_seed=0, device=None, auto_resume=None):
    """Build the training engine; returns ``(engine, optimizer,
    dataloader, lr_scheduler)``.

    Counterpart of ``deepspeed_tpu.initialize`` (``__init__.py:21``) on
    one device: the engine runs on ``model.device`` (CUDA unless the model
    was built with ``device="cpu"``), or on ``device`` for a
    ``loss_fn`` + ``params`` pair, which defaults to CUDA and raises
    without a card.  ``auto_resume`` (then ``DSTPU_AUTO_RESUME``, then
    the config's ``checkpoint.auto_resume``) restarts from the newest
    valid checkpoint in ``checkpoint.dir``.  The JAX package's client
    optimizer / scheduler, mesh, pipeline, elastic and monitor arguments
    are not ported."""
    from .runtime.engine import DeepSpeedEngine
    engine = DeepSpeedEngine(model=model, config=config, training_data=training_data,
                             loss_fn=loss_fn, params=params, rng_seed=rng_seed,
                             device=device)
    _maybe_auto_resume(engine, auto_resume)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def _maybe_auto_resume(engine, auto_resume):
    """Resolve the auto-resume request (kwarg > env > config) and restart
    from the newest valid checkpoint in ``checkpoint.dir`` if there is one
    (JAX ``__init__.py:90-118``); a directory with no checkpoint is a cold
    start, logged, not an error."""
    import os
    from .utils.logging import log_dist
    ckpt_cfg = engine.config.checkpoint_config
    if auto_resume is None:
        env = os.environ.get("DSTPU_AUTO_RESUME")
        if env:      # when set, it can also disable a config's auto_resume
            auto_resume = env.lower() in ("1", "true", "yes")
        else:
            auto_resume = ckpt_cfg.auto_resume
    if not auto_resume:
        return
    load_dir = ckpt_cfg.dir
    if not load_dir:
        from .runtime.config import DeepSpeedConfigError
        raise DeepSpeedConfigError("auto_resume needs checkpoint.dir in the config "
                                   "(where to look)")
    from .checkpoint import atomic
    atomic.clean_stale_staging(load_dir, min_age_s=atomic.LOAD_STAGING_MIN_AGE_S)
    # cold-start detection only: tag resolution, verification and the
    # torn-tag fallback happen inside load_checkpoint
    if not atomic.has_checkpoint(load_dir):
        log_dist(f"auto_resume: no checkpoint in {load_dir}; cold start", ranks=[0])
        return
    path, _ = engine.load_checkpoint(load_dir)
    log_dist(f"auto_resume: restarted from {path}", ranks=[0])


def init_inference(model=None, **kwargs):
    """Build an ``InferenceEngine`` (counterpart of
    ``deepspeed_tpu.init_inference``, ``__init__.py:169-172``):
    ``init_inference(model, params=..., dtype=torch.int8)`` serves with
    int8 weights."""
    from .inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)


__all__ = ["__version__", "initialize", "init_inference"]
