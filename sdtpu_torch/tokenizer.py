"""The CLIP BPE tokenizer of the port: sdtpu's, re-exported.

`sdtpu.tokenizer` is pure Python (it needs the `regex` package, no jax),
so the port encodes prompts with the same ids. Callers of the port import
it from here.
"""

from sdtpu.tokenizer import SimpleTokenizer  # noqa: F401
