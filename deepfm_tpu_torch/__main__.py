from deepfm_tpu_torch.cli import main

main()
