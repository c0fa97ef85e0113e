"""Experimental tools of the port. Counterpart of ``kaolin_tpu/experimental``."""
