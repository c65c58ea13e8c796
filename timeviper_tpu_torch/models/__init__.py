"""Models of the port: ViT, projector, Nemotron-H backbone, VLM, generation."""
