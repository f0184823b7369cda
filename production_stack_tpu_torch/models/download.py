"""Checkpoint downloader: HF repo -> local dir (PVC populator).

Role parity with the reference's HF-downloader sidecar (reference:
scripts/huggingface_downloader.py:23, docker/Dockerfile.sidecar): runs as
a one-off job or init container to land weights on a shared volume so
serving pods never pull from the network (tutorial 03).

Counterpart of ``production_stack_tpu/models/download.py``: the same
patterns, message and CLI. ``huggingface_hub`` is imported only when a
download runs (the machine with the card may lack it).

Usage:
  python -m production_stack_tpu_torch.models.download <hf-repo-id> <dest-dir>
"""

from __future__ import annotations

import os
import sys

try:
    from production_stack_tpu_torch.utils import init_logger
except ImportError:  # standalone, copied without its package
    import logging

    logging.basicConfig(level=logging.INFO)
    init_logger = logging.getLogger

logger = init_logger(__name__)

WEIGHT_PATTERNS = [
    "*.safetensors", "*.json", "*.model", "*.txt", "*.bin",
]


def download(repo_id: str, dest: str, token: str | None = None) -> str:
    """Download a checkpoint snapshot into `dest`; returns the path."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover - hub ships w/ transformers
        raise RuntimeError(
            "huggingface_hub is required for downloading; in air-gapped "
            "environments place the checkpoint directory on the volume "
            "yourself (models/weights.py loads any local dir)"
        ) from e
    os.makedirs(dest, exist_ok=True)
    path = snapshot_download(
        repo_id,
        local_dir=dest,
        allow_patterns=WEIGHT_PATTERNS,
        token=token or os.environ.get("HF_TOKEN"),
    )
    logger.info("downloaded %s -> %s", repo_id, path)
    return path


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    download(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
