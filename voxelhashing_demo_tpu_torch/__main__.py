"""``python -m voxelhashing_demo_tpu_torch``: the CLI (cli.py)."""

from .cli import main

main()
