"""`python -m robust_cvd_tpu_torch`: the port's CLI (main.py)."""

from .main import main

if __name__ == "__main__":
    main()
