"""The benchmark's plain reference: CLAIRE's registration in plain PyTorch
(``claire``) and the comparison that decides ``correct`` (``judge``)."""
