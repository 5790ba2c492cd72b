"""``python -m onepose_tpu_torch.train``: the training entry
(``train/entry.py``)."""
from onepose_tpu_torch.train.entry import main

if __name__ == "__main__":
    main()
