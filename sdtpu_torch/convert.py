"""Weight conversion from the command line, argv-compatible with sdtpu's
convert.py:

    python -m sdtpu_torch.convert <dump_path> <model_name>        # npy tree -> native
    python -m sdtpu_torch.convert --ckpt <sd.ckpt> <model_name>   # torch ckpt -> native
    python -m sdtpu_torch.convert --mpk <model.mpk> <model_name>  # Burn mpk -> native
    python -m sdtpu_torch.convert --to-dump <native> <dump_path>  # native -> npy tree
    python -m sdtpu_torch.convert --to-mpk <native> <mpk_path>    # native -> Burn mpk

[--preset P] names the configuration of a dump, ckpt or mpk (sd-v1-4 by
default). See sdtpu_torch.cli.
"""
from sdtpu_torch.cli import convert_main

if __name__ == "__main__":
    convert_main()
