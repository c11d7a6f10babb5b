"""Face toolkit of the port: the restore helper (detect, align, paste
back) and the detector / parser factories."""
