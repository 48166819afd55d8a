"""Models fed from the decode path: the ViT encoder (`vit`)."""
