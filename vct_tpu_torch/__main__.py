"""`python -m vct_tpu_torch ...` — see vct_tpu_torch/cli.py."""

from vct_tpu_torch.cli import main

if __name__ == "__main__":
    main()
