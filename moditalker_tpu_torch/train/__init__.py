"""The trainers: AToM and the MToV latent diffusion."""
