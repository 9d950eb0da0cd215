"""Training-side pieces the serving slice needs: best-checkpoint
persistence and batched prediction. The trainer comes with a later slice."""
