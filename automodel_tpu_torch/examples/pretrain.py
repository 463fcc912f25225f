"""Pretraining runs the SFT recipe as it is (counterpart:
``examples/llm_pretrain/pretrain.py``): ``automodel-torch pretrain llm``
maps to the same recipe.

    python automodel_tpu_torch/examples/pretrain.py \\
        -c examples/llm_pretrain/nanogpt_pretrain.yaml \\
        --dataset.file_pattern "<shards>/*.bin" [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

from automodel_tpu_torch.recipes.llm.train_ft import main  # noqa: E402

if __name__ == "__main__":
    main()
