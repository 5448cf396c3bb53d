"""Text-to-image from the command line, argv-compatible with the reference
`sample` binary and sdtpu's sample.py:

    python -m sdtpu_torch.sample <burn|dump|native|ckpt> <model> <cfg_scale> \\
        <n_steps> <prompt> <out_name> [cuda|cpu] [--seed N] [--bf16] ...

Runs on the card unless `cpu` is given; see sdtpu_torch.cli for the flags.
"""
from sdtpu_torch.cli import sample_main

if __name__ == "__main__":
    sample_main()
