"""Atomic checkpoint commit protocol + integrity manifest.

Counterpart of ``deepspeed_tpu/checkpoint/atomic.py``, ported whole and
unchanged in behaviour: the same staging suffix, manifest format,
verification levels, ``latest`` pointer, fallback order, staging cleanup
and ``keep_n`` rotation, so either package verifies, resolves and
rotates the other's tags.  No deliberate differences.

A checkpoint is crash-consistent iff a preemption at ANY instant leaves the
directory tree in a state the loader can recover from.  The protocol:

1. ``save_checkpoint`` writes every file into a ``<tag>.tmp`` staging dir.
2. ``write_manifest`` records per-file SHA-256 + byte sizes + engine meta
   into ``manifest.json`` (itself fsynced).
3. ``commit_staged`` fsyncs every staged file, then publishes with a single
   ``os.rename(<tag>.tmp, <tag>)`` and fsyncs the parent directory — the
   only atom in the protocol.
4. The ``latest`` pointer is updated write-temp-then-rename AFTER commit.

The loader side (``verify_checkpoint`` / ``find_latest_valid``) treats a
``.tmp`` dir as garbage from a killed save, and any tag whose manifest is
missing or whose checksums mismatch as torn; ``rotate_checkpoints`` applies
a ``checkpoint.keep_n`` retention policy that never deletes the newest
valid tag.
"""

import hashlib
import json
import os
import shutil
import time

from ..utils.logging import logger
from .constants import LATEST_FILE, MODEL_FILE

class CheckpointValidationError(RuntimeError):
    """An explicitly requested checkpoint failed manifest validation."""


MANIFEST_FILE = "manifest.json"
STAGE_SUFFIX = ".tmp"
# staging dirs younger than this are skipped by LOAD-path cleanup: they may
# be another process's in-flight save (eval job sharing a live trainer's
# dir).  Savers clean with age 0 — they own the directory.
LOAD_STAGING_MIN_AGE_S = 900.0
_HASH_CHUNK = 1 << 20


def fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path):
    """Durably record directory entries (renames/creates) themselves."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse fsync on directories; rename is still atomic
    finally:
        os.close(fd)


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def stage_path(save_dir, tag):
    return os.path.join(save_dir, f"{tag}{STAGE_SUFFIX}")


def atomic_write_text(path, text):
    """Write-temp + fsync + rename: readers see the old or the new content,
    never a torn write.  Used for the ``latest`` pointer."""
    tmp = f"{path}{STAGE_SUFFIX}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def write_latest(save_dir, tag):
    from .. import fault
    fault.site("ckpt.before_latest")
    atomic_write_text(os.path.join(save_dir, LATEST_FILE), str(tag))


def read_latest(save_dir):
    path = os.path.join(save_dir, LATEST_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return f.read().strip() or None


def write_manifest(ckpt_dir, meta=None):
    """Hash every file currently staged in ``ckpt_dir`` into
    ``manifest.json`` alongside engine meta (tag, global step, ...)."""
    files = {}
    for root, _, names in os.walk(ckpt_dir):
        for name in sorted(names):
            if name == MANIFEST_FILE:
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, ckpt_dir)
            files[rel] = {"sha256": sha256_file(full),
                          "size": os.path.getsize(full)}
    manifest = {"version": 1, "files": files, "meta": meta or {}}
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def read_manifest(ckpt_dir):
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint(ckpt_dir, level="full"):
    """Validate a committed checkpoint against its manifest.

    ``level``: ``"full"`` re-hashes every file; ``"size"`` checks existence
    and byte sizes only (cheap); ``"off"`` only requires the manifest to
    parse.  Returns ``(ok, problems)`` with one human-readable string per
    defect — a torn checkpoint must be *explainable*, not just rejected.
    """
    problems = []
    if not os.path.isdir(ckpt_dir):
        return False, [f"missing checkpoint dir {ckpt_dir}"]
    if os.path.basename(ckpt_dir).endswith(STAGE_SUFFIX):
        return False, [f"{ckpt_dir} is an uncommitted staging dir"]
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return False, [f"missing or unreadable {MANIFEST_FILE} in {ckpt_dir}"]
    if level == "off":
        return True, []
    files = manifest.get("files", {})
    if not isinstance(files, dict):
        return False, [f"malformed {MANIFEST_FILE}: 'files' is not a map"]
    for rel, rec in files.items():
        full = os.path.join(ckpt_dir, rel)
        try:
            if not os.path.isfile(full):
                problems.append(f"{rel}: missing")
                continue
            size = os.path.getsize(full)
            if size != rec["size"]:
                problems.append(f"{rel}: size {size} != manifest {rec['size']}")
                continue
            if level == "full" and sha256_file(full) != rec["sha256"]:
                problems.append(f"{rel}: sha256 mismatch")
        except (OSError, KeyError, TypeError) as e:
            # an unreadable file — or a manifest that parses but lacks the
            # expected record fields (hand-edited, foreign tool, future
            # format rev) — makes THIS tag invalid; it must not abort the
            # caller's newest-valid fallback scan over the other tags
            problems.append(f"{rel}: unreadable or malformed record "
                            f"({type(e).__name__}: {e})")
    return not problems, problems


def commit_staged(save_dir, tag, fsync=True):
    """Publish ``<tag>.tmp`` as ``<tag>``: fsync staged files, one rename,
    fsync the parent.  ``fsync=False`` (``checkpoint.fsync`` off) skips the
    per-file durability pass — throwaway runs only; the rename itself stays
    atomic either way."""
    staged = stage_path(save_dir, tag)
    final = os.path.join(save_dir, str(tag))
    if fsync:
        for root, _, names in os.walk(staged):
            for name in names:
                fsync_file(os.path.join(root, name))
            fsync_dir(root)
    if os.path.isdir(final):
        # an identically-tagged committed checkpoint exists; replace it
        # atomically-enough by moving it aside first (never leave zero
        # valid copies: the old one survives until the rename lands)
        trash = f"{final}.replaced"
        shutil.rmtree(trash, ignore_errors=True)
        os.rename(final, trash)
        os.rename(staged, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(staged, final)
    fsync_dir(save_dir)
    return final


def list_tags(save_dir):
    """Committed (non-staging) checkpoint dirs under ``save_dir``."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if os.path.isdir(full) and not name.endswith(STAGE_SUFFIX) \
                and not name.endswith(".replaced"):
            out.append(name)
    return out


def _tag_order_key(save_dir, tag):
    """Newest-first ordering: manifest global step, falling back to mtime."""
    ckpt_dir = os.path.join(save_dir, tag)
    manifest = read_manifest(ckpt_dir) or {}
    step = manifest.get("meta", {}).get("global_steps", -1)
    try:
        mtime = os.path.getmtime(ckpt_dir)
    except OSError:
        mtime = 0.0
    return (step, mtime)


def find_valid_tags(save_dir, level="full"):
    """Valid tags, newest first."""
    tags = sorted(list_tags(save_dir),
                  key=lambda t: _tag_order_key(save_dir, t), reverse=True)
    return [t for t in tags
            if verify_checkpoint(os.path.join(save_dir, t), level=level)[0]]


LEGACY_PROBE_FILE = MODEL_FILE


def is_legacy_checkpoint(ckpt_dir):
    """Pre-fault-tolerance layout.  A committed tag ALWAYS carries a
    manifest (it is written into staging before the publish rename), so a
    committed directory holding state files but no ``manifest.json`` can
    only be the old direct-write layout — loadable, just unverifiable."""
    return (os.path.isdir(ckpt_dir)
            and not os.path.basename(ckpt_dir).endswith(STAGE_SUFFIX)
            and not os.path.isfile(os.path.join(ckpt_dir, MANIFEST_FILE))
            and os.path.isfile(os.path.join(ckpt_dir, LEGACY_PROBE_FILE)))


def find_legacy_tags(save_dir):
    """Legacy (manifest-less) tags, newest first — the fallback of last
    resort when no manifested tag verifies."""
    tags = [t for t in list_tags(save_dir)
            if is_legacy_checkpoint(os.path.join(save_dir, t))]
    return sorted(tags, key=lambda t: _tag_order_key(save_dir, t),
                  reverse=True)


def has_checkpoint(save_dir):
    """Cheap probe: does ``save_dir`` hold anything resembling a committed
    checkpoint (a ``latest`` pointer, a manifested tag, or a legacy tag)?
    Stray directories (tensorboard logs, user data) don't count — an
    empty-ish dir is a cold start, not an error."""
    if read_latest(save_dir) is not None:
        return True
    return any(read_manifest(os.path.join(save_dir, t)) is not None
               or is_legacy_checkpoint(os.path.join(save_dir, t))
               for t in list_tags(save_dir))


def find_latest_valid(save_dir, exclude=(), level="full"):
    for tag in find_valid_tags(save_dir, level=level):
        if tag not in exclude:
            return tag
    return None


def clean_stale_staging(save_dir, min_age_s=0.0):
    """Remove ``.tmp`` staging dirs left by killed saves.

    ``min_age_s`` guards readers sharing a live trainer's checkpoint dir
    (an eval job, auto-resume of a second process): a ``.tmp`` younger than
    it may be an in-flight save, not a leftover, and is skipped — loaders
    never need the cleanup for correctness (staging dirs are invisible to
    tag resolution), only saves do, and the saver passes 0 because it owns
    the directory.

    A ``.replaced`` dir whose final name is missing is the OTHER kind of
    leftover: a same-tag re-commit was killed between its two renames, and
    the moved-aside copy is the only valid one — restore it (regardless of
    age) instead of deleting it (the never-zero-valid-copies invariant)."""
    if not os.path.isdir(save_dir):
        return []
    removed, restored = [], []

    def _rmtree_logged(path):
        # a leftover that cannot be removed must be reported, not swallowed:
        # the next save's makedirs on the same staging path would otherwise
        # fail with an unexplained FileExistsError
        try:
            shutil.rmtree(path)
        except OSError as e:
            logger.warning(f"could not remove stale checkpoint dir {path}: "
                           f"{e!r}; the next save of this tag will fail "
                           f"until it is cleared")
            return False
        return True

    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if not os.path.isdir(full):
            continue
        if name.endswith(".replaced"):
            final = full[:-len(".replaced")]
            if not os.path.isdir(final):
                os.rename(full, final)
                fsync_dir(save_dir)
                restored.append(name)
                continue
            if _rmtree_logged(full):
                removed.append(name)
        elif name.endswith(STAGE_SUFFIX):
            if min_age_s > 0:
                try:
                    age = time.time() - os.path.getmtime(full)
                except OSError:
                    age = min_age_s  # vanished mid-scan: nothing to skip
                if age < min_age_s:
                    continue  # possibly another process's in-flight save
            if _rmtree_logged(full):
                removed.append(name)
    if restored:
        logger.warning(f"restored checkpoint(s) {restored} in {save_dir} "
                       f"(re-commit was killed between renames)")
    if removed:
        logger.warning(f"removed stale checkpoint staging dirs {removed} "
                       f"(leftovers of a killed save) in {save_dir}")
    return removed


def rotate_checkpoints(save_dir, keep_n, level="size"):
    """Retention: keep the ``keep_n`` newest tags — and ALWAYS the newest
    valid one, even if it is older than the retention window (a fleet of
    torn newer tags must never evict the only recoverable state).

    Only directories carrying a ``manifest.json`` are rotation candidates:
    anything else under ``save_dir`` (tensorboard logs, legacy un-manifested
    checkpoints, user data) is never deleted by retention."""
    if not keep_n or keep_n < 1:
        return []
    tags = sorted((t for t in list_tags(save_dir)
                   if read_manifest(os.path.join(save_dir, t)) is not None),
                  key=lambda t: _tag_order_key(save_dir, t), reverse=True)
    keep = set(tags[:keep_n])
    newest_valid = find_latest_valid(save_dir, level=level)
    if newest_valid is not None:
        keep.add(newest_valid)
    removed = []
    for tag in tags:
        if tag in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        removed.append(tag)
    if removed:
        logger.info(f"checkpoint retention (keep_n={keep_n}): removed "
                    f"{removed}")
    return removed
