from kaolin_tpu_torch.experimental.dash3d.run import run_main

run_main()
