"""The LM substrate of the port: dense GQA transformer layers and model."""
