"""Structure from motion with known poses, on one device: extraction,
pair selection, matching, triangulation, global BA and postprocess
(``runner.run_sfm`` drives them)."""
