from sea_tpu_torch.cli import main

main()
