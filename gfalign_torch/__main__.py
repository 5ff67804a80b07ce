import os

from .cli.main import main

if __name__ == "__main__":
    raise SystemExit(main(device=os.environ.get("GFALIGN_TORCH_DEVICE", "cuda")))
