"""The repo's train-to-accuracy recipes on the port: ``train_synthetic``
(one full-width model per platform on a simulated genome) and
``train_production`` (batch 10,000 and the adaptive schedule on a simulated
flowcell), both scored on a held-out genome. ``clair_tpu_torch.demo`` is the
narrow-model demo; ``simulated`` holds the data chain and the scoring the
three share."""
