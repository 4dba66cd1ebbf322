"""Deployment shims over the port: the Replicate/Cog predictor
(cog_riffusion.py) and the Baseten/Truss model (baseten.py), the
counterparts of the repository's integrations/ package."""
